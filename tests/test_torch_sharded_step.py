"""The sharded sparse training step, port against the JAX package, on gloo
ranks (``tests/torch_dist_worker.py``; each world size spawned once).

* The DMP TwoTower step (``user``/``item`` one fat stack, d = 16: packed
  lines with the touched mask; the small tables row-sharded plain arrays),
  3 steps in each lookup mode at world 2 (data 1 x model 2) and world 4
  (data 2 x model 2), held at the trajectory rung (``TOL["trajectory"]``)
  to the JAX package's sharded step on the same meshes; at world 2 the
  ``gspmd`` and ``psum`` runs are also bitwise the port's single-device
  step (a psum with zeros is exact and the owner's sums keep input order),
  and every rank launches the fat-line update once a step.

The small DLRM and the dense regime are in
``tests/test_torch_sharded_dlrm_dense.py``, the placement rules in
``tests/test_torch_mesh.py``.
"""

import functools
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_dist_worker import Ranks

from tdfo_tpu.core.config import MeshSpec as JMeshSpec
from tdfo_tpu.core.mesh import make_mesh
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
from tdfo_tpu_torch.ops.sparse import sparse_optimizer as t_opt
from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection as TColl
from tdfo_tpu_torch.train.ctr import ctr_sparse_forward as t_fwd
from tdfo_tpu_torch.train.sparse_step import SparseTrainState as TState
from tdfo_tpu_torch.train.sparse_step import make_sparse_train_step as t_step

SIZE_MAP = {"user": 600, "item": 300, "language": 8, "is_ebook": 2,
            "format": 6, "publisher": 40, "pub_decade": 5}
COLS = {"user": "user_id", "item": "item_id", "language": "language",
        "is_ebook": "is_ebook", "format": "format", "publisher": "publisher",
        "pub_decade": "pub_decade"}
B, STEPS, LR, WD, D = 64, 3, 3e-4, 1e-4, 16
MESHES = {2: (1, 2), 4: (2, 2)}
MODES = ("gspmd", "psum", "alltoall")


def _batch(rng):
    out = {c: rng.integers(0, SIZE_MAP[f], B).astype(np.int32)
           for f, c in COLS.items()}
    out["user_id"][::8] = out["user_id"][1::8]  # duplicate ids in a batch
    out["avg_rating"] = rng.random(B, dtype=np.float32)
    out["num_pages"] = rng.random(B, dtype=np.float32)
    out["label"] = rng.integers(0, 2, B).astype(np.float32)
    return out


def _specs_dicts(specs):
    return [dict(name=s.name, num_embeddings=s.num_embeddings,
                 embedding_dim=s.embedding_dim, features=s.features,
                 sharding=s.sharding, init_scale=s.init_scale, fused=s.fused)
            for s in specs]


def _jrun(jc, jb, dense, jtables, batches, mode, mesh):
    jstate = JState.create(dense_params=dense, tx=optax.adamw(LR, weight_decay=WD),
                           tables=jtables,
                           sparse_opt=j_opt("adam", lr=LR, weight_decay=WD))
    run = j_step(jc, j_fwd(jb), mode=mode, donate=False)
    losses = []
    for b in batches:
        jstate, loss = run(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
    return losses, jstate


@functools.lru_cache(maxsize=None)
def _worlds():
    """Both worlds' ranks started at once, and their JAX sides computed
    side by side (XLA compiles in threads) while they run."""
    ranks = {w: Ranks(w, Path(tempfile.mkdtemp(prefix=f"sh_step_{w}_"))) for w in MESHES}
    with ThreadPoolExecutor(len(MESHES)) as pool:
        runs = {w: pool.submit(_twotower_world, w, r) for w, r in ranks.items()}
        return {w: r.result() for w, r in runs.items()}


def _twotower(world):
    return _worlds()[world]


def _twotower_world(world, ranks):
    mesh = make_mesh(JMeshSpec(data=MESHES[world][0], model=MESHES[world][1], seq=1),
                     devices=jax.devices()[:world])
    jc = JColl(j_specs(SIZE_MAP, D, "row", fused_threshold=100), mesh=mesh)
    jtables = jc.init(jax.random.key(0))
    jb = JBackbone(embed_dim=D)
    dense = jax.jit(jb.init)(jax.random.key(1),
                             {c: jnp.zeros((1, D)) for c in jc.features()},
                             {"avg_rating": jnp.zeros((1,)), "num_pages": jnp.zeros((1,))}
                             )["params"]
    rng = np.random.default_rng(world)
    batches = [_batch(rng) for _ in range(STEPS)]
    tables = {k: np.asarray(v) for k, v in jtables.items()}
    dense_np = jax.tree.map(np.asarray, dense)
    specs = _specs_dicts(t_specs(SIZE_MAP, D, "row", fused_threshold=100))
    cases = {f"twotower_{mode}": dict(
        fn="step", mesh=MESHES[world], specs=specs, tables=tables, dense=dense_np,
        model="twotower", d=D, batches=batches, mode=mode, lr=LR, wd=WD)
        for mode in MODES}
    ranks.send(cases)
    want = _jrun(jc, jb, dense, jtables, batches, "psum", mesh)  # while they run
    return {"want": want, "results": ranks.wait(), "tables": tables,
            "dense": dense_np, "batches": batches}


def _close_tables(got, want, what):
    rtol, atol = TOL["trajectory"]
    for name, g in got.items():
        w = np.asarray(want[name])[:g.shape[0]]
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"{what} {name}")


def _single_device(world):
    """The port's own single-device run of the world's case."""
    s = _twotower(world)
    tc = TColl(t_specs(SIZE_MAP, D, "row", fused_threshold=100))
    tb = TBackbone(D)
    tb.load_state_dict(backbone_params_from_flax(s["dense"]))
    one = {k: v[:tc.single_device_rows(k) // (tc.fat_layout_for(k).r if v.ndim == 3 else 1)]
           for k, v in s["tables"].items()}
    state = TState.create(backbone=tb, tables=tables_from_numpy(one),
                          sparse_opt=t_opt("adam", lr=LR, weight_decay=WD),
                          learning_rate=LR, weight_decay=WD)
    run = t_step(tc, t_fwd(tb))
    losses = []
    for b in s["batches"]:
        state, loss = run(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(loss))
    return losses, state


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_twotower_sharded_step_matches_jax(world, mode):
    s = _twotower(world)
    jl, jstate = s["want"]
    rtol, atol = TOL["trajectory"]
    for r, res in enumerate(s["results"]):
        got = res[f"twotower_{mode}"]
        assert got["fat_runs"] == STEPS  # the fat stack's shard, once a step
        np.testing.assert_allclose(got["losses"], jl, rtol=rtol, atol=atol)
        _close_tables(got["tables"], jstate.tables, f"rank {r}")
        for name, sl in got["slots"].items():
            for a, b in zip(sl, jstate.slots[name]):
                np.testing.assert_allclose(a, np.asarray(b)[:np.shape(a)[0]] if np.ndim(a)
                                           else np.asarray(b), rtol=rtol, atol=atol)
    # every rank ends with the same global state
    a, b = s["results"][0][f"twotower_{mode}"], s["results"][-1][f"twotower_{mode}"]
    for name in a["tables"]:
        np.testing.assert_array_equal(a["tables"][name], b["tables"][name])
    if world == 2 and mode != "alltoall":
        losses, state = _single_device(world)
        got = s["results"][0][f"twotower_{mode}"]
        assert got["losses"] == losses
        for name, t in state.tables.items():
            np.testing.assert_array_equal(got["tables"][name], t.numpy(), err_msg=name)
        for k, v in state.backbone.state_dict().items():
            np.testing.assert_array_equal(got["backbone"][k], v.numpy(), err_msg=k)
