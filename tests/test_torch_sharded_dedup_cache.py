"""``dedup_lookup``, the update cache, hot/cold tables and column sharding
under ``rowwise_adagrad`` on two gloo ranks (``tests/torch_dist_worker.py``;
two ranks spawned once for the file, running while the JAX side is
computed), against the JAX package's step on the same mesh and against the
port's own paths.  Meshes: data 1 x model 2 (``m2``: the tables' rows split
over the ranks, the step ``gspmd`` over model only) and data 2 x model 1
(``d2``: the Criteo recipe's layout, every table whole on each rank, the
batch split).

A small DLRM holds all three DLRM features at once: a rowwise fat table
(the routed kernel at model 1, ``fat_line_update`` on each shard at model
2) and a plain stack that is cached (flushed after step 2 and at the end)
and carries hot heads (a prefix, a scattered set and a fully hot table);
3 ``dedup_lookup`` steps on each mesh:

* against the reference's step on the same mesh at the trajectory rung
  (``TOL["trajectory"]``); the caches' live ids, frequencies and dirty
  bits and the overflow counts exactly the reference's, their rows at the
  rung; every rank's cache the same;
* within the port, bitwise: the default path (``dedup_lookup`` off),
  the uncached run after the flush (the reference's bars,
  ``tests/test_sparse_step.py``, ``tests/test_update_cache.py``), and at
  ``m2`` the single-device step;
* the effective tables (heads overlaid on the cold rows) equal the unsplit
  run's at rtol 1e-5 (``tests/test_hot_cold.py``).

Column sharding under rowwise_adagrad: the TwoTower tables column-sharded
and plain, against the reference at the rung and bitwise the port's
single-device step; and the update cache over column-sharded tables (each
rank caching its columns; a DLRM on two of the tables) against the
reference's cached step at the rung, its directories and overflow counts
exactly the reference's, and bitwise the uncached run.  The trainer: a Criteo-shaped fit at world 2 (``d2``)
with ``dedup_lookup``, the cache and ``hot_vocab`` restores at world 1 in
the single-device layout, and a world-1 checkpoint restores at world 2.
"""

import dataclasses
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
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch_dist_worker import Ranks

from tdfo_tpu.core.config import MeshSpec as JMeshSpec
from tdfo_tpu.core.mesh import make_mesh
from tdfo_tpu.models.dlrm import DLRMBackbone as JDLRM
from tdfo_tpu.models.dlrm import generic_embedding_specs as j_dlrm_specs
from tdfo_tpu.models.twotower import TwoTowerBackbone as JTwoTower
from tdfo_tpu.models.twotower import ctr_embedding_specs as j_tt_specs
from tdfo_tpu.ops.sparse import sparse_optimizer as j_opt
from tdfo_tpu.parallel.embedding import ShardedEmbeddingCollection as JColl
from tdfo_tpu.train.ctr import ctr_sparse_forward as j_fwd
from tdfo_tpu.train.sparse_step import SparseTrainState as JState
from tdfo_tpu.train.sparse_step import make_cache_flush_fn as j_flush_fn
from tdfo_tpu.train.sparse_step import make_sparse_train_step as j_step
from tdfo_tpu_torch.core.config import read_configs
from tdfo_tpu_torch.interop import (
    TOL,
    backbone_params_from_flax,
    flax_params_from_module,
    tables_from_numpy,
)
from tdfo_tpu_torch.models.dlrm import DLRMBackbone as TDLRM
from tdfo_tpu_torch.models.dlrm import generic_embedding_specs as t_dlrm_specs
from tdfo_tpu_torch.models.twotower import TwoTowerBackbone as TTwoTower
from tdfo_tpu_torch.models.twotower import ctr_embedding_specs as t_tt_specs
from tdfo_tpu_torch.ops.sparse import sparse_optimizer as t_opt
from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection as TColl
from tdfo_tpu_torch.train.ctr import ctr_sparse_forward as t_fwd
from tdfo_tpu_torch.train.sparse_step import SparseTrainState as TState
from tdfo_tpu_torch.train.sparse_step import make_sparse_train_step as t_step
from tdfo_tpu_torch.train.trainer import Trainer

SIZES = {"c0": 400, "c1": 90, "c2": 12, "c3": 500}
CATS, CONTS, DIM, B, STEPS = tuple(SIZES), ("x0", "x1"), 8, 64, 3
LR, WD, SPARSE_LR, KIND = 3e-4, 1e-4, 1e-2, "rowwise_adagrad"
# c3 (the one table above FUSED rows) is a rowwise fat array; c0-c2 one
# plain stack, cached, with hot heads: c0 a [0, K) prefix, c1 a scattered
# set, c2 fully hot
FUSED = 450
HOT = {"c0": np.arange(32, dtype=np.int32),
       "c1": np.array([1, 4, 5, 17, 40, 41, 88], np.int32),
       "c2": np.arange(12, dtype=np.int32)}
MESHES = {"m2": (1, 2), "d2": (2, 1)}
CACHE_ROWS, FLUSH_EVERY = 1024, 2
# the column cache's DLRM: two of the tables column-sharded and cached
# (the retained half of 256 rows covers a flush interval's 128 ids)
COL_CATS, COL_CACHE_ROWS = ("c0", "c3"), 256
STACK = "__tablestack_8_row_float32"
# the TwoTower tables of the column arm
TT_SIZES = {"user": 300, "item": 200, "language": 8, "is_ebook": 2,
            "format": 6, "publisher": 40, "pub_decade": 5}
TT_COLS = {"user": "user_id", "item": "item_id", "language": "language",
           "is_ebook": "is_ebook", "format": "format", "publisher": "publisher",
           "pub_decade": "pub_decade"}
TT_DIM = 16
RTOL, ATOL = TOL["trajectory"]


def _batch(rng):
    out = {c: rng.integers(0, v, B).astype(np.int32) for c, v in SIZES.items()}
    out["c0"][: B // 2] = rng.integers(0, 40, B // 2)  # mostly hot
    out["c1"][::4] = 5
    out.update({c: rng.random(B, dtype=np.float32) for c in CONTS})
    out["label"] = rng.integers(0, 2, B).astype(np.float32)
    return out


def _tt_batch(rng):
    out = {c: rng.integers(0, TT_SIZES[f], B).astype(np.int32)
           for f, c in TT_COLS.items()}
    out["user_id"][::8] = out["user_id"][1::8]
    out["avg_rating"] = rng.random(B, dtype=np.float32)
    out["num_pages"] = rng.random(B, dtype=np.float32)
    out["label"] = rng.integers(0, 2, B).astype(np.float32)
    return out


def _specs_dicts(specs):
    return [dict(name=s.name, num_embeddings=s.num_embeddings,
                 embedding_dim=s.embedding_dim, features=s.features,
                 sharding=s.sharding, init_scale=s.init_scale, fused=s.fused)
            for s in specs]


# the DLRM runs: name -> (hot heads, cache_rows, dedup_lookup); "all" is
# held to the reference, the others to "all" within the port
CONFIGS = {
    "all": (HOT, CACHE_ROWS, True),
    "default": (HOT, CACHE_ROWS, False),
    "eager": (HOT, 0, True),
    "unsplit": (None, 0, True),
}


def _jmesh(key):
    d, m = MESHES[key]
    return make_mesh(JMeshSpec(data=d, model=m, seq=1), devices=jax.devices()[:2])


def _jrun(jc, jb, dense, jtables, batches, *, dedup, flush=False, fwd=j_fwd):
    """The reference's steps: ``(losses, caches before the last flush,
    overflow counts, state)``."""
    jstate = JState.create(dense_params=dense, tx=optax.adamw(LR, weight_decay=WD),
                           tables=jtables, sparse_opt=j_opt(KIND, lr=SPARSE_LR))
    caches = jc.init_caches(jstate.tables, jstate.sparse_opt)
    jstate = dataclasses.replace(jstate, slots={**jstate.slots, **caches})
    run = j_step(jc, fwd(jb), donate=False, dedup_lookup=dedup)
    jflush = j_flush_fn(donate=False, mesh=jc.mesh) if flush else None
    losses, overs = [], []
    for i, b in enumerate(batches):
        jstate, loss = run(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
        if jflush is not None and (i + 1) % FLUSH_EVERY == 0 and i + 1 < len(batches):
            jstate, over = jflush(jstate)
            overs.append({k: int(v) for k, v in over.items()})
    before = {k: jax.tree.map(np.asarray, v) for k, v in jstate.slots.items()
              if k.startswith("__cache__/")}
    if jflush is not None:
        jstate, over = jflush(jstate)
        overs.append({k: int(v) for k, v in over.items()})
    return losses, before, overs, jstate


def _params(module):
    """A port module's seeded params as the reference's flax tree."""
    return jax.tree.map(jnp.asarray, flax_params_from_module(module))


@functools.lru_cache(maxsize=None)
def _runs():
    tmp = Path(tempfile.mkdtemp(prefix="sh_dedup_cache_"))
    ranks = Ranks(2, tmp / "ranks")
    rng = np.random.default_rng(14)
    batches = [_batch(rng) for _ in range(STEPS)]
    tt_batches = [_tt_batch(rng) for _ in range(STEPS)]
    jb = JDLRM(embed_dim=DIM, cat_columns=CATS, cont_columns=CONTS)
    dense = _params(TDLRM(DIM, cat_columns=CATS, cont_columns=CONTS,
                          generator=torch.Generator().manual_seed(1)))
    dense_np = jax.tree.map(np.asarray, dense)
    specs = _specs_dicts(t_dlrm_specs(SIZES, CATS, DIM, "row", fused_threshold=FUSED))
    # the port's single-device init, zero-padded to each mesh's rows
    init = TColl(t_dlrm_specs(SIZES, CATS, DIM, "row", fused_threshold=FUSED),
                 stack_tables=True, fused_kind=KIND, hot_ids=HOT).init(0, device="cpu")
    jcolls, cases = {}, {}
    for key in MESHES:
        mesh = _jmesh(key)
        jc = JColl(j_dlrm_specs(SIZES, CATS, DIM, "row", fused_threshold=FUSED),
                   mesh=mesh, stack_tables=True, fused_kind=KIND,
                   hot_ids=HOT, cache_rows=CACHE_ROWS)
        shapes = jax.eval_shape(jc.init, jax.random.key(0))
        jtables = {}
        for k, v in init.items():
            v, rows = v.numpy(), shapes[k].shape[0]
            v = np.concatenate([v, np.zeros((rows - v.shape[0], *v.shape[1:]), v.dtype)])
            jtables[k] = jax.device_put(v, NamedSharding(
                mesh, P() if k.endswith("__hot") else P("model")))
        jcolls[key] = (jc, jtables)
        tables = {k: np.asarray(v) for k, v in jtables.items()}
        for config, (hot, cache_rows, dedup) in CONFIGS.items():
            cases[f"{config}_{key}"] = dict(
                fn="step", mesh=MESHES[key], specs=specs,
                tables={k: v for k, v in tables.items()
                        if hot is not None or not k.endswith("__hot")},
                dense=dense_np, model="dlrm", d=DIM, cats=CATS, conts=CONTS,
                batches=batches, kind=KIND, stack_tables=True, hot=hot,
                cache_rows=cache_rows, dedup=dedup, flush_every=FLUSH_EVERY,
                lr=LR, wd=WD, sparse_lr=SPARSE_LR, sparse_wd=0.0)
    # the column arm: TwoTower tables column-sharded, plain
    mesh = _jmesh("m2")
    jcol = JColl(j_tt_specs(TT_SIZES, TT_DIM, "column", fused_threshold=None),
                 mesh=mesh, fused_kind=KIND)
    jcol_tables = {k: jax.device_put(v.numpy(), NamedSharding(mesh, P(None, "model")))
                   for k, v in TColl(t_tt_specs(TT_SIZES, TT_DIM, "column",
                                                fused_threshold=None)).init(
                       2, device="cpu").items()}
    jtt = JTwoTower(embed_dim=TT_DIM)
    tt_dense = _params(TTwoTower(TT_DIM, generator=torch.Generator().manual_seed(3)))
    cases["column_m2"] = dict(
        fn="step", mesh=MESHES["m2"],
        specs=_specs_dicts(t_tt_specs(TT_SIZES, TT_DIM, "column", fused_threshold=None)),
        tables={k: np.asarray(v) for k, v in jcol_tables.items()},
        dense=jax.tree.map(np.asarray, tt_dense), model="twotower", d=TT_DIM,
        batches=tt_batches, kind=KIND, lr=LR, wd=WD, sparse_lr=SPARSE_LR, sparse_wd=0.0)
    # the update cache over column-sharded tables: a DLRM on two of them,
    # cached and not
    col_sizes = {c: SIZES[c] for c in COL_CATS}
    jcol_cached = JColl(j_dlrm_specs(col_sizes, COL_CATS, DIM, "column",
                                     fused_threshold=None),
                        mesh=mesh, fused_kind=KIND, cache_rows=COL_CACHE_ROWS)
    col_tables = TColl(t_dlrm_specs(col_sizes, COL_CATS, DIM, "column",
                                    fused_threshold=None)).init(2, device="cpu")
    jcol_cached_tables = {k: jax.device_put(v.numpy(), NamedSharding(
        mesh, P(None, "model"))) for k, v in col_tables.items()}
    jcol_b = JDLRM(embed_dim=DIM, cat_columns=COL_CATS, cont_columns=CONTS)
    col_dense = _params(TDLRM(DIM, cat_columns=COL_CATS, cont_columns=CONTS,
                              generator=torch.Generator().manual_seed(4)))
    cases["column_eager_m2"] = dict(
        fn="step", mesh=MESHES["m2"],
        specs=_specs_dicts(t_dlrm_specs(col_sizes, COL_CATS, DIM, "column",
                                        fused_threshold=None)),
        tables={k: v.numpy() for k, v in col_tables.items()},
        dense=jax.tree.map(np.asarray, col_dense), model="dlrm", d=DIM,
        cats=COL_CATS, conts=CONTS, batches=batches, kind=KIND, lr=LR, wd=WD,
        sparse_lr=SPARSE_LR, sparse_wd=0.0)
    cases["column_cache_m2"] = dict(cases["column_eager_m2"], cache_rows=COL_CACHE_ROWS,
                                    flush_every=FLUSH_EVERY)
    # the trainer: a world-2 fit, and a world-1 checkpoint restored at world 2
    criteo, size_map = _criteo(tmp)
    one = Trainer(read_configs(None, **_fit_body(criteo, size_map, tmp / "w1")),
                  device="cpu")
    one.fit()
    cases["fit"] = dict(fn="fit", body=_fit_body(criteo, size_map, tmp / "w2",
                                                 mesh={"data": 2, "model": 1}))
    cases["restore"] = dict(fn="restore", body=_fit_body(
        criteo, size_map, tmp / "w1", mesh={"data": 2, "model": 1}))
    ranks.send(cases)
    # the reference side while the ranks run
    # (four programs: XLA compiles them side by side)
    with ThreadPoolExecutor(4) as pool:
        want = {key: pool.submit(_jrun, jc, jb, dense, jtables, batches, dedup=True,
                                 flush=True) for key, (jc, jtables) in jcolls.items()}
        want["column"] = pool.submit(_jrun, jcol, jtt, tt_dense, jcol_tables,
                                     tt_batches, dedup=False)
        want["column_cache"] = pool.submit(_jrun, jcol_cached, jcol_b, col_dense,
                                           jcol_cached_tables, batches, dedup=False,
                                           flush=True)
        want = {k: v.result() for k, v in want.items()}
    return {"results": ranks.wait(), "want": want, "batches": batches,
            "tt_batches": tt_batches, "cases": cases, "one": one,
            "criteo": (criteo, size_map), "tmp": tmp}


def _criteo(tmp):
    from tdfo_tpu_torch.data.criteo_preprocessing import run_criteo_preprocessing
    from tdfo_tpu_torch.data.synthetic import write_synthetic_criteo

    write_synthetic_criteo(tmp / "criteo", n_rows=1200, seed=3)
    size_map = run_criteo_preprocessing(tmp / "criteo", hot_vocab=24,
                                        hot_fraction=0.6, file_num=2)
    return tmp / "criteo", size_map


def _fit_body(criteo, size_map, ckpt, **kw):
    from tdfo_tpu_torch.data.criteo_preprocessing import (
        CRITEO_CATEGORICAL,
        CRITEO_CONTINUOUS,
    )

    body = dict(
        data_dir=str(criteo), model="dlrm", n_epochs=1, embed_dim=8,
        learning_rate=3e-3, per_device_train_batch_size=64,
        per_device_eval_batch_size=256, shuffle_buffer_size=300,
        log_every_n_steps=2, checkpoint_dir=str(ckpt), checkpoint_every_n_steps=3,
        size_map=size_map, seed=7, categorical_features=list(CRITEO_CATEGORICAL),
        continuous_features=list(CRITEO_CONTINUOUS), stack_tables=True,
        dedup_lookup=True, sparse_optimizer=KIND, fused_table_threshold=-1,
        embeddings=dict(cache_rows=2048, flush_every=2, hot_vocab=24))
    body.update(kw)
    return body


def _result(name):
    return [r[name] for r in _runs()["results"]]


def _close(got, want, what):
    for name, g in got.items():
        w = np.asarray(want[name])[:np.shape(g)[0]]
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"{what} {name}")


def _same_on_both_ranks(res, what):
    a, b = res
    assert a["losses"] == b["losses"], what
    for name in a["tables"]:
        np.testing.assert_array_equal(a["tables"][name], b["tables"][name],
                                      err_msg=f"{what} {name}")


def _assert_bitwise(a, b, what):
    assert a["losses"] == b["losses"], what
    assert sorted(a["tables"]) == sorted(b["tables"])
    for name in a["tables"]:
        np.testing.assert_array_equal(a["tables"][name], b["tables"][name],
                                      err_msg=f"{what} {name}")
        for x, y in zip(a["slots"].get(name, ()), b["slots"].get(name, ())):
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {name} slot")


def _single_device(case):
    """The port's single-device run of a rank case (no cache; its tables
    cut to the single-device rows)."""
    if case["model"] == "dlrm":
        tc = TColl(t_dlrm_specs(SIZES, CATS, DIM, "row", fused_threshold=FUSED),
                   stack_tables=True, fused_kind=KIND, hot_ids=case["hot"])
        tb = TDLRM(DIM, cat_columns=CATS, cont_columns=CONTS)
    else:
        tc = TColl(t_tt_specs(TT_SIZES, TT_DIM, "column", fused_threshold=None),
                   fused_kind=KIND)
        tb = TTwoTower(TT_DIM)
    tb.load_state_dict(backbone_params_from_flax(case["dense"]))
    one = {k: v if k.endswith("__hot") else v[:tc.single_device_rows(k) // (
        tc.fat_layout_for(k).r if v.ndim == 3 else 1)]
        for k, v in case["tables"].items()}
    state = TState.create(backbone=tb, tables=tables_from_numpy(one),
                          sparse_opt=t_opt(KIND, lr=SPARSE_LR), learning_rate=LR,
                          weight_decay=WD)
    run = t_step(tc, t_fwd(tb), dedup_lookup=case.get("dedup", False))
    losses = []
    for b in case["batches"]:
        state, loss = run(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(loss))
    return {"losses": losses, "tables": {k: v.numpy() for k, v in state.tables.items()},
            "slots": {k: [x.numpy() for x in v] for k, v in state.slots.items()}}


def _held_to_jax(got, want, what):
    jl, _, _, jstate = want
    np.testing.assert_allclose(got["losses"], jl, rtol=RTOL, atol=ATOL, err_msg=what)
    _close(got["tables"], jstate.tables, what)
    for name, sl in got["slots"].items():
        for a, b in zip(sl, jstate.slots[name]):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b[:np.shape(a)[0]] if b.ndim else b,
                                       rtol=RTOL, atol=ATOL, err_msg=f"{what} {name}")


@pytest.mark.parametrize("key", list(MESHES))
def test_dedup_under_a_mesh_matches_jax_and_the_default_path(key):
    """The dedup step with the fat array, the cache and the hot heads
    against the reference's; dedup == default bitwise; at data 1 x model 2
    the single-device step's bits."""
    s = _runs()
    res = _result(f"all_{key}")
    for r, got in enumerate(res):
        _held_to_jax(got, s["want"][key], f"rank {r}")
        # model 1: the routed kernel on the replicated fat array; model 2:
        # the default sharded update, fat_line_update on each rank's shard
        want_runs = (0, STEPS) if key == "d2" else (STEPS, 0)
        assert (got["fat_runs"], got["routed_runs"]) == want_runs, key
        _assert_bitwise(got, _result(f"default_{key}")[r], f"default {key}")
    _same_on_both_ranks(res, key)
    if key == "m2":  # gspmd over model only: the single-device step's bits
        _assert_bitwise(res[0], _single_device(s["cases"]["eager_m2"]), "single device")


def _live(cache):
    ids, slot = np.asarray(cache["ids"]), np.asarray(cache["slot"])
    live = ids < 2**31 - 1
    return {int(i): {k: np.asarray(cache[k])[p] for k in ("rows", "acc", "freq", "dirty")}
            for i, p in zip(ids[live], slot[live])}


@pytest.mark.parametrize("key", list(MESHES))
def test_cached_steps_match_jax_and_the_uncached_run(key):
    s = _runs()
    res = _result(f"all_{key}")
    ckey = "__cache__/" + STACK
    _, jcaches, jovers, _ = s["want"][key]
    want = _live(jcaches[ckey])
    for r, got in enumerate(res):
        assert got["overflow"] == jovers == [{STACK: 0}] * 2
        # cached == eager, bitwise, after the last flush
        _assert_bitwise(got, _result(f"eager_{key}")[r], f"cached {key}")
        live = _live(got["caches"][ckey])
        assert sorted(live) == sorted(want)  # the live directory, exactly
        for i, w in want.items():
            for k in ("freq", "dirty"):
                np.testing.assert_array_equal(live[i][k], w[k], err_msg=f"{i} {k}")
            for k in ("rows", "acc"):
                np.testing.assert_allclose(live[i][k], w[k], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{i} {k}")
    # every rank holds the same cache
    a, b = (_live(x["caches"][ckey]) for x in res)
    assert all(all(np.array_equal(a[i][k], b[i][k]) for k in a[i]) for i in a)


def _effective(tables, hot):
    """Each logical table: its cold rows with the head's rows overlaid."""
    coll = TColl(t_dlrm_specs(SIZES, CATS, DIM, "row", fused_threshold=FUSED),
                 stack_tables=True, hot_ids=hot)
    out = {}
    for c in CATS[:3]:
        tname = coll.resolve(c)[1].name
        aname, spec, off = coll.resolve_table(tname)
        eff = np.array(tables[aname][off:off + spec.num_embeddings])
        if coll.hot_count(tname):
            eff[coll.hot_ids[tname]] = tables[coll.hot_array_name(tname)]
        out[c] = eff
    return out


@pytest.mark.parametrize("key", list(MESHES))
def test_hot_cold_under_a_mesh_matches_the_unsplit_table(key):
    """Fully hot, prefix and scattered heads, replicated on both ranks: the
    effective tables equal the unsplit run's (the head's input-order sums
    against the cold stack's dedupe order) at rtol 1e-5."""
    for r, got in enumerate(_result(f"all_{key}")):
        base = _result(f"unsplit_{key}")[r]
        np.testing.assert_allclose(got["losses"], base["losses"], rtol=1e-5)
        eff, eff_base = _effective(got["tables"], HOT), _effective(base["tables"], None)
        for c in eff:
            np.testing.assert_allclose(eff[c], eff_base[c], rtol=1e-5, atol=1e-6,
                                       err_msg=c)
        np.testing.assert_allclose(got["tables"]["c3_embed"], base["tables"]["c3_embed"],
                                   rtol=1e-5, atol=1e-6)
        assert got["local_rows"]["c2_embed__hot"] == (12, DIM)  # replicated heads


def test_column_sharding_under_rowwise_adagrad():
    s = _runs()
    res = _result("column_m2")
    one = _single_device(s["cases"]["column_m2"])
    for r, got in enumerate(res):
        # the slots are the [V] row accumulators, whole on each rank
        _held_to_jax(got, s["want"]["column"], f"rank {r}")
        for name in got["slots"]:
            assert got["local_rows"][name][1] == TT_DIM // 2
        _assert_bitwise(got, one, f"rank {r} single device")


def test_column_sharding_with_the_update_cache():
    """Each rank caches its columns of every column-sharded table (the
    directory and the whole-row accumulator replicated): the reference's
    cached step at the rung, its live directories, frequencies, dirty bits
    and overflow counts exactly, and bitwise the uncached column run."""
    s = _runs()
    _, jcaches, jovers, _ = s["want"]["column_cache"]
    res = _result("column_cache_m2")
    for r, got in enumerate(res):
        _held_to_jax(got, s["want"]["column_cache"], f"rank {r}")
        _assert_bitwise(got, _result("column_eager_m2")[r], f"rank {r} cached")
        assert got["overflow"] == jovers
        assert all(v == 0 for o in jovers for v in o.values()) and len(jovers) == 2
        assert sorted(got["caches"]) == sorted(jcaches) and len(jcaches) == 2
        for ckey, jc in jcaches.items():
            live, want = _live(got["caches"][ckey]), _live(jc)
            assert sorted(live) == sorted(want), ckey
            for i, w in want.items():
                for k in ("freq", "dirty"):
                    np.testing.assert_array_equal(live[i][k], w[k], err_msg=f"{i} {k}")
                for k in ("rows", "acc"):
                    np.testing.assert_allclose(live[i][k], w[k], rtol=RTOL, atol=ATOL,
                                               err_msg=f"{ckey} {i} {k}")
        # gathered to the single-device layout (what a checkpoint holds,
        # and a world-1 run restores) and taken back to this rank's columns
        assert got["cache_roundtrip"]
        # the cache's value rows are this rank's columns
        for name in got["local_rows"]:
            assert got["local_rows"][name][1] == DIM // 2
    a, b = (x["caches"] for x in res)
    for ckey in a:
        for k in a[ckey]:
            np.testing.assert_array_equal(a[ckey][k], b[ckey][k], err_msg=f"{ckey} {k}")


def test_world_two_fit_with_dedup_cache_and_hot_restores_at_world_one():
    s = _runs()
    criteo, size_map = s["criteo"]
    fit = _result("fit")
    assert fit[0]["tables"].keys() == fit[1]["tables"].keys()
    tr = Trainer(read_configs(None, **_fit_body(criteo, size_map, s["tmp"] / "w2")),
                 device="cpu")
    assert tr.coll.hot_tables() and tr.coll.cache_rows
    step, state = tr.restore_latest()
    assert step == fit[0]["step"] > 0
    from tdfo_tpu_torch.interop import gather_to_numpy

    for k, v in gather_to_numpy(tr.coll, state.tables)[0].items():
        np.testing.assert_array_equal(v, fit[0]["tables"][k], err_msg=k)
        np.testing.assert_array_equal(v, fit[1]["tables"][k], err_msg=k)
    # and a world-1 checkpoint restores at world 2, on both ranks
    one = s["one"]
    want = gather_to_numpy(one.coll, one.state.tables)[0]
    for r in _result("restore"):
        assert r["step"] == one.state.step
        for k, v in want.items():
            np.testing.assert_array_equal(r["tables"][k], v, err_msg=k)
