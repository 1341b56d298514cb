"""The whole TwoTower sparse training step, PyTorch port against the JAX
package: a 3-step trajectory at tiny size from the same JAX-made tables and
flax params.  ``user``/``item`` are fat (one stacked fat array) while the
five small tables take the lazy dense adam tier.  Losses, the final fat
array, the small tables and their slots agree at rtol 1e-4 / atol 1e-6;
every step launches the port's ``fat_line_update`` wrapper once.

The learning rate is the headline's 3e-4.  Adam's early steps normalise
each gradient element by its own magnitude, so an element whose gradient
is near zero turns a summation-order difference (autograd vs XLA) into an
update difference of up to ``lr``: at lr 3e-3 three of ~250k elements
leave the 1e-4 band (``ROADMAP.md`` Queue C), at 3e-4 none do."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tdfo_tpu.models.twotower import TwoTowerBackbone as JBackbone
from tdfo_tpu.models.twotower import ctr_embedding_specs as j_specs
from tdfo_tpu.ops.sparse import sparse_optimizer as j_opt
from tdfo_tpu.parallel.embedding import ShardedEmbeddingCollection as JColl
from tdfo_tpu.train.ctr import ctr_sparse_forward as j_fwd
from tdfo_tpu.train.sparse_step import SparseTrainState as JState
from tdfo_tpu.train.sparse_step import make_sparse_train_step as j_step
from tdfo_tpu_torch.interop import TOL, backbone_params_from_flax, tables_from_numpy
from tdfo_tpu_torch.models.twotower import TwoTowerBackbone as TBackbone
from tdfo_tpu_torch.models.twotower import ctr_embedding_specs as t_specs
from tdfo_tpu_torch.ops.kernels import fat_line_update as tk
from tdfo_tpu_torch.ops.sparse import sparse_optimizer as t_opt
from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection as TColl
from tdfo_tpu_torch.train.ctr import ctr_sparse_forward as t_fwd
from tdfo_tpu_torch.train.ctr import make_ctr_sparse_eval_step
from tdfo_tpu_torch.train.sparse_step import SparseTrainState as TState
from tdfo_tpu_torch.train.sparse_step import make_sparse_train_step as t_step

# bench.py's SIZE_MAP scaled down; fused_threshold 100 makes user/item fat
SIZE_MAP = {"user": 600, "item": 300, "language": 8, "is_ebook": 2,
            "format": 6, "publisher": 40, "pub_decade": 5}
COLS = {"user": "user_id", "item": "item_id", "language": "language",
        "is_ebook": "is_ebook", "format": "format", "publisher": "publisher",
        "pub_decade": "pub_decade"}
B, STEPS, LR, WD = 64, 3, 3e-4, 1e-4


def _batch(rng):
    out = {c: rng.integers(0, SIZE_MAP[f], B).astype(np.int32)
           for f, c in COLS.items()}
    out["user_id"][::8] = out["user_id"][1::8]  # duplicate ids in a batch
    out["avg_rating"] = rng.random(B, dtype=np.float32)
    out["num_pages"] = rng.random(B, dtype=np.float32)
    out["label"] = rng.integers(0, 2, B).astype(np.float32)
    return out


@pytest.mark.parametrize("d", [16, 64])
def test_three_step_trajectory_matches_jax(d):
    rng = np.random.default_rng(100 + d)
    batches = [_batch(rng) for _ in range(STEPS)]

    jc = JColl(j_specs(SIZE_MAP, d, "row", fused_threshold=100))
    jtables = jc.init(jax.random.key(0))
    jb = JBackbone(embed_dim=d)
    dense = jb.init(jax.random.key(1),
                    {c: jnp.zeros((1, d)) for c in jc.features()},
                    {"avg_rating": jnp.zeros((1,)), "num_pages": jnp.zeros((1,))}
                    )["params"]
    jstate = JState.create(dense_params=dense,
                           tx=optax.adamw(LR, weight_decay=WD), tables=jtables,
                           sparse_opt=j_opt("adam", lr=LR, weight_decay=WD))
    jrun = j_step(jc, j_fwd(jb), donate=False)

    tc = TColl(t_specs(SIZE_MAP, d, "row", fused_threshold=100))
    tb = TBackbone(d)
    tb.load_state_dict(backbone_params_from_flax(jax.tree.map(np.asarray, dense)))
    tstate = TState.create(
        backbone=tb, tables=tables_from_numpy({k: np.asarray(v) for k, v in jtables.items()}),
        sparse_opt=t_opt("adam", lr=LR, weight_decay=WD), learning_rate=LR,
        weight_decay=WD)
    trun = t_step(tc, t_fwd(tb))
    fat = [k for k, v in tstate.tables.items() if v.dim() == 3]
    assert fat == [f"__fatstack_{d}_row"]

    jl, tl = [], []
    before = tk.fat_line_update.launches
    for b in batches:
        jstate, loss = jrun(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jl.append(float(loss))
        tstate, loss = trun(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        tl.append(float(loss))
    assert tk.fat_line_update.launches == before + STEPS  # one fat array
    assert tstate.step == STEPS

    rtol, atol = TOL["trajectory"]
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=atol)
    for name, jt in jstate.tables.items():
        np.testing.assert_allclose(tstate.tables[name].numpy(), np.asarray(jt),
                                   rtol=rtol, atol=atol, err_msg=name)
        for a, b in zip(tstate.slots[name], jstate.slots[name]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                       atol=atol, err_msg=name)
    for name, p in tb.state_dict().items():
        mod, layer, kind = name.split(".")
        jp = np.asarray(jstate.dense_params[mod][layer][
            "kernel" if kind == "weight" else "bias"])
        np.testing.assert_allclose(p.numpy(), jp.T if kind == "weight" else jp,
                                   rtol=rtol, atol=atol, err_msg=name)

    # the eval step reads the trained tables like the reference's
    from tdfo_tpu.train.ctr import make_ctr_sparse_eval_step as j_eval

    b = batches[0]
    jloss, jlog = j_eval(jc, jb)(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    tloss, tlog = make_ctr_sparse_eval_step(tc, tb)(
        tstate, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=rtol, atol=atol)


def test_unported_step_options_refuse():
    tc = TColl(t_specs(SIZE_MAP, 8, "row"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_step(tc, lambda e, b: None, dedup_lookup=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_step(tc, lambda e, b: None, mode="alltoall")
