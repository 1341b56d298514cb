"""The sharded step beyond the TwoTower headline, port against the JAX
package, on two gloo ranks (``tests/torch_dist_worker.py``, spawned once):

* a small DLRM with ``stack_tables`` (a fat and a plain stack) at data 1 x
  model 2, ``psum``, 3 steps at the trajectory rung (``TOL["trajectory"]``)
  of the JAX package's sharded step on the same mesh;
* the dense TwoTower regime (every parameter under AdamW) data-parallel
  at data 2, against the JAX dense step on the global batch; the two
  replicas stay identical;
* the same regime under the PS partition (``ps_min_shard_bytes`` = 1280:
  ``user``, ``item`` and the item tower's first kernel split) at data 1 x
  model 2 and data 2 x model 1: the split leaves are the reference rule's,
  the moments are blocks, the runs are bitwise the port's one-device step
  at model 2 and within its trajectory rung where the batch splits, and
  at the rung of the JAX step on its PS-sharded state (data 1 x model 2).
"""

import functools
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
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
PS_BYTES = 1280  # a block of >= 1280 bytes: user, item, item_tower/fc1/kernel
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
    from tdfo_tpu.models.twotower import TwoTower as JTwoTower
    from tdfo_tpu.models.twotower import dummy_batch
    from tdfo_tpu.train.state import TrainState as JTS
    from tdfo_tpu.train.state import make_adamw as j_adamw
    from tdfo_tpu.train.step import make_train_step as j_make_step

    sizes = {"user": 60, "item": 40, "language": 5, "is_ebook": 2,
             "format": 4, "publisher": 7, "pub_decade": 6}
    # the reference's init_twotower, its init jitted (the same params)
    model = JTwoTower(size_map=sizes, embed_dim=D)
    params = jax.jit(model.init)(jax.random.key(0), dummy_batch())["params"]
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(STEPS):
        b = {("user_id" if f == "user" else "item_id" if f == "item" else f):
             rng.integers(0, v, 32).astype(np.int32) for f, v in sizes.items()}
        b["avg_rating"] = rng.uniform(0, 5, 32).astype(np.float32)
        b["num_pages"] = rng.uniform(0, 1, 32).astype(np.float32)
        b["label"] = rng.integers(0, 2, 32).astype(np.float32)
        batches.append(b)

    def want(ps=False):
        """The JAX dense step on the global batch; ``ps``: on its
        PS-sharded state over a data 1 x model 2 mesh, with the split
        leaves' paths."""
        from tdfo_tpu.parallel.sharding import min_size_partitioner_rule, shard_state

        jstate = JTS.create(apply_fn=model.apply, params=params, tx=j_adamw(LR, WD))
        kw, split = {}, []
        if ps:
            jmesh = make_mesh(JMeshSpec(data=1, model=2, seq=1),
                              devices=jax.devices()[:2])
            jstate = shard_state(jstate, jmesh, min_size_partitioner_rule(jmesh, PS_BYTES))
            kw["mesh"] = jmesh
            split = sorted("/".join(str(getattr(k, "key", k)) for k in path)
                           for path, leaf in jax.tree_util.tree_leaves_with_path(
                               jstate.params)
                           if any(ax is not None for ax in leaf.sharding.spec))
        jstep = j_make_step(donate_state=False, **kw)
        losses = []
        for b in batches:
            jstate, loss = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(loss))
        return losses, jax.tree.map(np.asarray, jstate.params), split

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
    for key, mesh_shape in (("ps_m2", (1, 2)), ("ps_d2", (2, 1))):
        cases[key] = dict(cases["dense_data2"], mesh=mesh_shape, ps=PS_BYTES)
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
            "want_ps": want_dense(ps=True), "dense_case": cases["dense_data2"],
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
    jl, jparams, _ = s["want_dense"]
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


def _one_device(case):
    """The port's dense step on one device over the global batches."""
    import torch

    from tdfo_tpu_torch.interop import dense_params_from_flax
    from tdfo_tpu_torch.models.twotower import init_twotower
    from tdfo_tpu_torch.train.state import TrainState
    from tdfo_tpu_torch.train.step import make_train_step

    model = init_twotower(0, case["size_map"], case["d"], device="cpu")
    model.load_state_dict(dense_params_from_flax(case["dense"]))
    state = TrainState.create(model=model, learning_rate=LR, weight_decay=WD)
    step, losses = make_train_step(), []
    for b in case["batches"]:
        state, loss = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(loss))
    return losses, {k: v.detach().numpy() for k, v in model.named_parameters()}


@pytest.mark.parametrize("key", ["ps_m2", "ps_d2"])
def test_dense_regime_ps_partition(key):
    """Each split leaf a block (its moments too), the plan the reference
    rule's, bitwise one device at model 2 and within the rung where the
    batch splits; both ranks end with the same whole parameters."""
    from tdfo_tpu_torch.interop import dense_params_from_flax

    s = _setup()
    losses, params = _one_device(s["dense_case"])
    jl, jparams, jsplit = s["want_ps"]
    jwant = {k: v.numpy() for k, v in dense_params_from_flax(jparams).items()}
    rtol, atol = TOL["trajectory"]
    for res in s["results"]:
        got = res[key]
        if key == "ps_m2":
            assert got["split"] == jsplit == ["item_embed/embedding",
                                              "item_tower/fc1/kernel",
                                              "user_embed/embedding"]
            halved = {"user_embed.weight": 0, "item_embed.weight": 0,
                      "item_tower.fc1.weight": 1}  # torch layout [out, in]
            for name, shape in got["local"].items():
                want_shape = list(params[name].shape)
                if name in halved:
                    want_shape[halved[name]] //= 2
                assert got["moments"][name] == shape == tuple(want_shape), name
            assert got["losses"] == losses
            for k, v in params.items():
                np.testing.assert_array_equal(got["params"][k], v, err_msg=k)
            np.testing.assert_allclose(got["losses"], jl, rtol=rtol, atol=atol)
            for k, v in jwant.items():
                np.testing.assert_allclose(got["params"][k], v, rtol=rtol, atol=atol,
                                           err_msg=k)
        else:  # model 1: nothing splits; the batch does
            assert got["split"] == [] and got["local"] == {
                k: v.shape for k, v in params.items()}
            np.testing.assert_allclose(got["losses"], losses, rtol=rtol, atol=atol)
            for k, v in params.items():
                np.testing.assert_allclose(got["params"][k], v, rtol=rtol, atol=atol,
                                           err_msg=k)
    a, b = (r[key]["params"] for r in s["results"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
