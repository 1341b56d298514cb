"""The sharded step beyond the TwoTower headline, port against the JAX
package, on two gloo ranks (``tests/torch_dist_worker.py``, spawned once):

* a small DLRM with ``stack_tables`` (a fat and a plain stack) at data 1 x
  model 2, ``psum``, 3 steps at the trajectory rung (``TOL["trajectory"]``)
  of the JAX package's sharded step on the same mesh;
* the dense TwoTower regime (every parameter under AdamW) data-parallel
  at data 2, against the JAX dense step on the global batch; the two
  replicas stay identical.
"""

import functools
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
from torch_dist_worker import Ranks

from tdfo_tpu.core.config import MeshSpec as JMeshSpec
from tdfo_tpu.core.mesh import make_mesh
from tdfo_tpu.models.dlrm import DLRMBackbone as JDLRM
from tdfo_tpu.models.dlrm import generic_embedding_specs as j_dlrm_specs
from tdfo_tpu.ops.sparse import sparse_optimizer as j_opt
from tdfo_tpu.parallel.embedding import ShardedEmbeddingCollection as JColl
from tdfo_tpu.train.ctr import ctr_sparse_forward as j_fwd
from tdfo_tpu.train.sparse_step import SparseTrainState as JState
from tdfo_tpu.train.sparse_step import make_sparse_train_step as j_step
from tdfo_tpu_torch.interop import TOL
from tdfo_tpu_torch.models.dlrm import generic_embedding_specs as t_dlrm

B, STEPS, LR, WD, D = 64, 3, 3e-4, 1e-4, 16
D_SIZES = {"c0": 301, "c1": 37, "c2": 5, "c3": 520, "c4": 120}
D_CATS, D_CONTS = tuple(D_SIZES), ("x0", "x1")


def _dlrm_batch(rng):
    out = {c: rng.integers(0, v, B).astype(np.int32) for c, v in D_SIZES.items()}
    out.update({c: rng.random(B, dtype=np.float32) for c in D_CONTS})
    out["label"] = rng.integers(0, 2, B).astype(np.float32)
    return out


def _close_tables(got, want, what):
    rtol, atol = TOL["trajectory"]
    for name, g in got.items():
        w = np.asarray(want[name])[:g.shape[0]]
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"{what} {name}")


def _dense_case():
    """Two ranks of data 2 on the dense regime's TwoTower, and a thunk of
    the JAX dense step on the global batch."""
    from tdfo_tpu.models.twotower import init_twotower as j_init
    from tdfo_tpu.train.state import TrainState as JTS
    from tdfo_tpu.train.state import make_adamw as j_adamw
    from tdfo_tpu.train.step import make_train_step as j_make_step

    sizes = {"user": 60, "item": 40, "language": 5, "is_ebook": 2,
             "format": 4, "publisher": 7, "pub_decade": 6}
    model, params = j_init(jax.random.key(0), sizes, D)
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(STEPS):
        b = {("user_id" if f == "user" else "item_id" if f == "item" else f):
             rng.integers(0, v, 32).astype(np.int32) for f, v in sizes.items()}
        b["avg_rating"] = rng.uniform(0, 5, 32).astype(np.float32)
        b["num_pages"] = rng.uniform(0, 1, 32).astype(np.float32)
        b["label"] = rng.integers(0, 2, 32).astype(np.float32)
        batches.append(b)

    def want():
        jstate = JTS.create(apply_fn=model.apply, params=params, tx=j_adamw(LR, WD))
        jstep = j_make_step(donate_state=False)
        losses = []
        for b in batches:
            jstate, loss = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(loss))
        return losses, jax.tree.map(np.asarray, jstate.params)

    case = dict(fn="dense_step", mesh=(2, 1), size_map=sizes, d=D,
                dense=jax.tree.map(np.asarray, params), batches=batches, lr=LR, wd=WD)
    return case, want


@functools.lru_cache(maxsize=None)
def _setup():
    ranks = Ranks(2, Path(tempfile.mkdtemp(prefix="sh_dlrm_dense_")))
    mesh = make_mesh(JMeshSpec(data=1, model=2, seq=1), devices=jax.devices()[:2])
    jdc = JColl(j_dlrm_specs(D_SIZES, D_CATS, D, "row", fused_threshold=100),
                mesh=mesh, stack_tables=True)
    jdt = jdc.init(jax.random.key(2))
    jdb = JDLRM(embed_dim=D, cat_columns=D_CATS, cont_columns=D_CONTS)
    ddense = jax.jit(jdb.init)(jax.random.key(3),
                               {c: jnp.zeros((1, D)) for c in D_CATS},
                               {c: jnp.zeros((1,)) for c in D_CONTS})["params"]
    rng = np.random.default_rng(12)
    dbatches = [_dlrm_batch(rng) for _ in range(STEPS)]
    specs = [dict(name=s.name, num_embeddings=s.num_embeddings,
                  embedding_dim=s.embedding_dim, features=s.features,
                  sharding=s.sharding, init_scale=s.init_scale, fused=s.fused)
             for s in t_dlrm(D_SIZES, D_CATS, D, "row", fused_threshold=100)]
    cases = {"dlrm_psum": dict(
        fn="step", mesh=(1, 2), stack_tables=True, specs=specs,
        tables={k: np.asarray(v) for k, v in jdt.items()},
        dense=jax.tree.map(np.asarray, ddense), model="dlrm", d=D,
        cats=D_CATS, conts=D_CONTS, batches=dbatches, mode="psum", lr=LR, wd=WD)}
    cases["dense_data2"], want_dense = _dense_case()
    ranks.send(cases)
    # the JAX steps while the ranks run
    jstate = JState.create(dense_params=ddense, tx=optax.adamw(LR, weight_decay=WD),
                           tables=jdt, sparse_opt=j_opt("adam", lr=LR, weight_decay=WD))
    run = j_step(jdc, j_fwd(jdb), mode="psum", donate=False)
    jl = []
    for b in dbatches:
        jstate, loss = run(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jl.append(float(loss))
    return {"want_dlrm": (jl, jstate), "want_dense": want_dense(),
            "results": ranks.wait()}


def test_dlrm_stack_tables_sharded_step_matches_jax():
    s = _setup()
    jl, jstate = s["want_dlrm"]
    rtol, atol = TOL["trajectory"]
    for res in s["results"]:
        got = res["dlrm_psum"]
        assert sorted(got["tables"]) == ["__fatstack_16_row",
                                         "__tablestack_16_row_float32"]
        np.testing.assert_allclose(got["losses"], jl, rtol=rtol, atol=atol)
        _close_tables(got["tables"], jstate.tables, "dlrm")


def test_dense_regime_data_parallel_matches_jax():
    from tdfo_tpu_torch.interop import dense_params_from_flax

    s = _setup()
    jl, jparams = s["want_dense"]
    want = {k: v.numpy() for k, v in dense_params_from_flax(jparams).items()}
    rtol, atol = TOL["trajectory"]
    for res in s["results"]:
        got = res["dense_data2"]
        np.testing.assert_allclose(got["losses"], jl, rtol=rtol, atol=atol)
        for k, v in want.items():
            np.testing.assert_allclose(got["params"][k], v, rtol=rtol, atol=atol,
                                       err_msg=k)
    a, b = (r["dense_data2"]["params"] for r in s["results"])
    for k in a:  # the replicas stay identical
        np.testing.assert_array_equal(a[k], b[k])
