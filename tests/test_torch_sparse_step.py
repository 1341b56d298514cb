"""The whole sparse training step, PyTorch port against the JAX package: a
3-step trajectory at tiny size from the same JAX-made tables and flax
params.  TwoTower: ``user``/``item`` are fat (one stacked fat array) while
the five small tables take the lazy dense adam tier; every step launches the
port's ``fat_line_update`` wrapper once.  DLRM with ``dedup_lookup``: a fat
stack and a plain stack (``stack_tables``); every step launches
``fat_line_update_routed`` once and ``fat_line_update`` never, and the
dedup forward gathers what the default lookup gathers.  Losses, tables and
slots agree at rtol 1e-4 / atol 1e-6 (``TOL["trajectory"]``).

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

from tdfo_tpu.models.dlrm import DLRMBackbone as JDLRM
from tdfo_tpu.models.dlrm import generic_embedding_specs as j_dlrm_specs
from tdfo_tpu.models.twotower import TwoTowerBackbone as JBackbone
from tdfo_tpu.models.twotower import ctr_embedding_specs as j_specs
from tdfo_tpu.ops.sparse import sparse_optimizer as j_opt
from tdfo_tpu.parallel.embedding import ShardedEmbeddingCollection as JColl
from tdfo_tpu.train.ctr import ctr_sparse_forward as j_fwd
from tdfo_tpu.train.sparse_step import SparseTrainState as JState
from tdfo_tpu.train.sparse_step import make_sparse_train_step as j_step
from tdfo_tpu_torch.interop import TOL, backbone_params_from_flax, tables_from_numpy
from tdfo_tpu_torch.models.dlrm import DLRMBackbone as TDLRM
from tdfo_tpu_torch.models.dlrm import generic_embedding_specs as t_dlrm_specs
from tdfo_tpu_torch.models.twotower import TwoTowerBackbone as TBackbone
from tdfo_tpu_torch.models.twotower import ctr_embedding_specs as t_specs
from tdfo_tpu_torch.ops.fat_lines import fat_view
from tdfo_tpu_torch.ops.kernels import fat_line_update as tk
from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as tkr
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
    jtables = jax.jit(jc.init)(jax.random.key(0))
    jb = JBackbone(embed_dim=d)
    dense = jax.jit(jb.init)(jax.random.key(1),
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
    before = tk.fat_line_update.plain_runs
    for b in batches:
        jstate, loss = jrun(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jl.append(float(loss))
        tstate, loss = trun(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        tl.append(float(loss))
    assert tk.fat_line_update.plain_runs == before + STEPS  # one fat array
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


# DLRM-shaped dedup lookup: c0 and c3 fat (one stack), the rest one plain
# stack; c3's rows straddle an unaligned stack offset
D_SIZES = {"c0": 301, "c1": 37, "c2": 5, "c3": 520, "c4": 120}
D_CATS, D_CONTS, D_DIM = tuple(D_SIZES), ("x0", "x1"), 16
# adam at the headline's lr (see the module docstring); rowwise_adagrad
# normalises per row, so a larger step stays inside the ladder
SPARSE_LR = {"rowwise_adagrad": 1e-2, "adam": LR}


def _dlrm_batch(rng, b=B):
    out = {c: rng.integers(0, v, b).astype(np.int32) for c, v in D_SIZES.items()}
    out["c0"][::8] = out["c0"][1::8]  # duplicate ids in a batch
    out.update({c: rng.random(b, dtype=np.float32) for c in D_CONTS})
    out["label"] = rng.integers(0, 2, b).astype(np.float32)
    return out


def _dlrm_port(kind, jtables, dense, **step_kw):
    tc = TColl(t_dlrm_specs(D_SIZES, D_CATS, D_DIM, "row", fused_threshold=100),
               stack_tables=True, fused_kind=kind)
    tb = TDLRM(D_DIM, cat_columns=D_CATS, cont_columns=D_CONTS)
    tb.load_state_dict(backbone_params_from_flax(jax.tree.map(np.asarray, dense)))
    tstate = TState.create(
        backbone=tb, tables=tables_from_numpy({k: np.asarray(v) for k, v in jtables.items()}),
        sparse_opt=t_opt(kind, lr=SPARSE_LR[kind]), learning_rate=LR,
        weight_decay=WD)
    return tc, tstate, t_step(tc, t_fwd(tb), **step_kw)


def _dlrm_jax(kind):
    jc = JColl(j_dlrm_specs(D_SIZES, D_CATS, D_DIM, "row", fused_threshold=100),
               stack_tables=True, fused_kind=kind)
    jtables = jax.jit(jc.init)(jax.random.key(0))
    jb = JDLRM(embed_dim=D_DIM, cat_columns=D_CATS, cont_columns=D_CONTS)
    dense = jax.jit(jb.init)(jax.random.key(1),
                             {c: jnp.zeros((1, D_DIM)) for c in D_CATS},
                             {c: jnp.zeros((1,)) for c in D_CONTS})["params"]
    jstate = JState.create(dense_params=dense,
                           tx=optax.adamw(LR, weight_decay=WD), tables=jtables,
                           sparse_opt=j_opt(kind, lr=SPARSE_LR[kind]))
    return jc, jb, jstate


@pytest.mark.parametrize("kind", ["rowwise_adagrad", "adam"])
def test_dedup_lookup_trajectory_matches_jax(kind):
    """rowwise_adagrad: the fat stack routed, the plain stack
    ``update_unique``; adam: the plain stack (162 rows) keeps the raw-id
    dense tier (the ``small_adam`` exclusion)."""
    rng = np.random.default_rng(7)
    batches = [_dlrm_batch(rng) for _ in range(STEPS)]
    jc, jb, jstate = _dlrm_jax(kind)
    jrun = j_step(jc, j_fwd(jb), donate=False, dedup_lookup=True)
    tc, tstate, trun = _dlrm_port(kind, jstate.tables, jstate.dense_params,
                                  dedup_lookup=True)
    assert sorted(tstate.tables) == ["__fatstack_16_row", "__tablestack_16_row_float32"]
    jl, tl = [], []
    before = (tk.fat_line_update.plain_runs, tkr.fat_line_update_routed.plain_runs)
    for b in batches:
        jstate, loss = jrun(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jl.append(float(loss))
        tstate, loss = trun(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        tl.append(float(loss))
    assert (tk.fat_line_update.plain_runs,
            tkr.fat_line_update_routed.plain_runs) == (before[0], before[1] + STEPS)
    rtol, atol = TOL["trajectory"]
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=atol)
    for name, jt in jstate.tables.items():
        np.testing.assert_allclose(tstate.tables[name].numpy(), np.asarray(jt),
                                   rtol=rtol, atol=atol, err_msg=name)
        for a, b in zip(tstate.slots[name], jstate.slots[name]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                       atol=atol, err_msg=name)


def test_dedup_forward_gathers_what_the_lookup_gathers():
    """The dedup forward's vectors equal the default lookup's bit for bit
    (ids past a table included: a fat line past the stack reads NaN, a
    plain id past the stack NaN), except at negative ids, which read row 0
    of their array as in the reference (the default lookup adds the stack
    offset to them)."""
    rng = np.random.default_rng(8)
    jc, jb, jstate = _dlrm_jax("rowwise_adagrad")
    seen = {}
    lin = torch.nn.Linear(1, 1)

    def record(embs, batch):
        seen.update({k: v.detach().clone() for k, v in embs.items()})
        return (sum(v.nan_to_num().sum() for v in embs.values())
                + sum(p.sum() for p in lin.parameters()))

    tc = TColl(t_dlrm_specs(D_SIZES, D_CATS, D_DIM, "row", fused_threshold=100),
               stack_tables=True, fused_kind="rowwise_adagrad")
    tables = tables_from_numpy({k: np.asarray(v) for k, v in jstate.tables.items()})
    state = TState.create(backbone=lin, tables=tables,
                          sparse_opt=t_opt("rowwise_adagrad", lr=0.0),
                          learning_rate=0.0, weight_decay=0.0)
    b = _dlrm_batch(rng)
    b["c3"][3] = 999        # past the fat stack's last line: NaN
    b["c4"][5] = 200        # past the plain stack: NaN
    b["c1"][:4] = [-1, -1, -7, 2]
    b["c3"][7] = -1
    ids = {c: torch.from_numpy(b[c]) for c in D_CATS}
    want = tc.lookup(tables, ids)
    t_step(tc, record, dedup_lookup=True)(state, dict(ids))
    fat = fat_view(tables["__fatstack_16_row"], tc.fat_layout_for("__fatstack_16_row"))
    row0 = {"__fatstack_16_row": fat[0, :D_DIM],
            "__tablestack_16_row_float32": tables["__tablestack_16_row_float32"][0]}
    for c in D_CATS:
        neg = ids[c] < 0
        np.testing.assert_array_equal(seen[c][~neg].numpy(), want[c][~neg].numpy())
        assert torch.equal(seen[c][neg], row0[tc.resolve(c)[0]].expand(int(neg.sum()), -1))
    assert torch.isnan(seen["c3"][3]).all() and torch.isnan(seen["c4"][5]).all()


def test_unported_step_options_refuse():
    tc = TColl(t_specs(SIZE_MAP, 8, "row"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_step(tc, lambda e, b: None, mode="psum")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_step(tc, lambda e, b: None, mode="alltoall")
