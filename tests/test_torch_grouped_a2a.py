"""The grouped all-to-all exchange, its int8 narrow wire and int8 storage
under a mesh, and the pipelined sparse step, on two gloo ranks
(``tests/torch_dist_worker.py``, mesh data 1 x model 2; spawned once for
every case, before the JAX side is built), against the per-table program,
a sequential per-table reference and the JAX package
(``tests/test_grouped_a2a.py`` holds the reference's own versions).

Held, with the ladder's rung named at each check (``interop.TOL``):

* the grouped forward equals the per-table ``alltoall`` forward bitwise,
  with and without ``stack_tables``, padding ids reading zeros;
* the grouped update equals a sequential per-table ``opt.update`` on the
  whole arrays bitwise (rowwise_adagrad, as the reference's test), and the
  JAX package's ``grouped_update`` at the optimizer rung (XLA's fused
  multiply-adds);
* ``all_to_all_single`` calls at the collectives boundary: 2 for a grouped
  lookup and 2 for its update at 26 tables (52 for the per-table
  lookup), 4 for a pipelined step (1 for ``prime``, 3 for ``flush``);
* the pipelined step equals the eager grouped step bitwise over 4 batches
  (losses, tables, slots), and the eager per-table step too;
* a finite capacity drops the same ids forward and backward, and the
  grouped ``a2a_overflow`` count is the hand-computed one;
* replicated tables take the per-feature path beside the group;
* int8 under the mesh: the psum, alltoall and grouped lookups (plain and
  fused int8 in one group, which ships f32 and the identity grid) equal
  the JAX package's bitwise (the decode is exact); one per-table and one
  grouped stochastically rounded update at the narrow rung: codes within
  one grid step of the JAX package's (different uniform draws: the port
  folds each rank's key with its model index), sidecars and moments at
  the optimizer rung, untouched rows bitwise, sidecars gathered into the
  single-device layout;
* ``Trainer.fit`` with ``grouped_a2a`` and ``pipeline_overlap``: bitwise
  the same fit with the pipeline off (every logged loss, the train AUC,
  the tables), and killed before its 6th step and resumed, bitwise the
  uninterrupted run; an int8 grouped config trains at world 2 and its
  checkpoint restores at world 1; the pipelined step refuses a
  collection without the grouped exchange or a mesh.
"""

import functools
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch_dist_worker import Ranks

from tdfo_tpu.core.config import MeshSpec as JMeshSpec
from tdfo_tpu.core.mesh import make_mesh
from tdfo_tpu.ops import quant as jq
from tdfo_tpu.ops.sparse import sparse_optimizer as jopt
from tdfo_tpu.parallel.embedding import EmbeddingSpec as JSpec
from tdfo_tpu.parallel.embedding import ShardedEmbeddingCollection as JColl
from tdfo_tpu_torch.interop import TOL, tables_from_numpy, to_numpy
from tdfo_tpu_torch.ops.sparse import sparse_optimizer

B, D, M = 64, 8, 2
LR = 0.05
MESH = (1, M)
RTOL, ATOL = TOL["optimizer"]


def _specs(n, *, dtype="float32", fused=()):
    return [dict(name=f"t{i}", num_embeddings=40 + 9 * i, embedding_dim=D,
                 features=(f"f{i}",), sharding="row", init_scale=0.1,
                 dtype=dtype, fused=i in fused) for i in range(n)]


def _tspecs(specs):
    return [dict(s, dtype=getattr(torch, s["dtype"])) for s in specs]


def _jcoll(specs, mesh, **kw):
    return JColl([JSpec(**dict(s, dtype=getattr(jnp, s["dtype"]))) for s in specs],
                 mesh=mesh, **kw)


def _ids(n, seed, *, vocab=40, pad=True):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        ids = rng.integers(0, vocab, B).astype(np.int32)
        if pad:
            ids[::7] = -1
        out[f"f{i}"] = ids
    return out


def _grads(feats, seed):
    rng = np.random.default_rng(seed)
    return {f: rng.standard_normal((B, D)).astype(np.float32) for f in feats}


def _tables(specs, seed, **kw):
    """The port's single-device init of ``specs`` as numpy arrays (the
    ranks shard them; the JAX side takes them padded, :func:`_padded`)."""
    from tdfo_tpu_torch.parallel.embedding import (
        EmbeddingSpec,
        ShardedEmbeddingCollection,
    )

    coll = ShardedEmbeddingCollection([EmbeddingSpec(**s) for s in _tspecs(specs)],
                                      **kw)
    return {k: to_numpy(v) for k, v in coll.init(seed, device="cpu").items()}


def _padded(jc, tables):
    """``tables`` with zero rows (fat: lines) up to the reference's padded
    vocab under its mesh."""
    out = {}
    for k, a in tables.items():
        parent = k.removeprefix("__qscale__/")
        rows = jc._array_vocab_rows(parent)
        if a.ndim == 3:
            rows //= jc.fat_layout_for(parent).r
        out[k] = np.concatenate([a, np.zeros((rows - a.shape[0], *a.shape[1:]),
                                             a.dtype)])
    return out


# ------------------------------------------------------------------ the cases

TWOTOWER_SIZES = {"user": 300, "item": 260, "language": 6, "is_ebook": 2,
                  "format": 8, "publisher": 30, "pub_decade": 12}


def _twotower_case(seed=5):
    """Small TwoTower shapes: user + item fat (one stack), five plain
    row-sharded tables, all d = 8 f32: one group."""
    from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection
    from tdfo_tpu_torch.interop import flax_params_from_module

    specs = ctr_embedding_specs(TWOTOWER_SIZES, D, "row", fused_threshold=100)
    coll = ShardedEmbeddingCollection(specs)
    tables = {k: to_numpy(v) for k, v in coll.init(seed, device="cpu").items()}
    bb = TwoTowerBackbone(D, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(4):
        b = {}
        for s in specs:
            b[s.features[0]] = rng.integers(0, s.num_embeddings, B).astype(np.int32)
        b["label"] = rng.integers(0, 2, B).astype(np.int8)
        for c in ("avg_rating", "num_pages"):
            b[c] = rng.random(B).astype(np.float32)
        batches.append(b)
    return dict(fn="grouped_steps", mesh=MESH,
                specs=[{k: getattr(s, k) for k in ("name", "num_embeddings",
                        "embedding_dim", "features", "sharding", "init_scale",
                        "dtype", "fused")} for s in specs],
                tables=tables, batches=batches, model="twotower", d=D,
                dense=flax_params_from_module(bb), lr=3e-3, wd=1e-4)


def _capacity_case():
    """Every id owned by shard 0 under capacity factor 0.5: the combined
    stream of 2 tables overflows its bucket."""
    specs = _tspecs(_specs(2))
    z = {f"f{i}": np.zeros((B,), np.int32) for i in range(2)}
    return dict(fn="grouped", mesh=MESH, specs=specs, grouped=True, cf=0.5,
                kind="rowwise_adagrad", features=z,
                grads={f: np.ones((B, D), np.float32) for f in z}, lr=LR, step=0)


@functools.lru_cache(maxsize=None)
def _setup():
    ranks = Ranks(2, Path(tempfile.mkdtemp(prefix="grouped_ranks_")))
    fit = _fit_bodies()
    jmesh = make_mesh(JMeshSpec(data=1, model=M, seq=1), devices=jax.devices()[:M])
    cases, jax_jobs = {}, {}
    # f32: grouped vs per-table, with and without stacking; the update
    for stack in (False, True):
        specs = _specs(5)
        jc = _jcoll(specs, jmesh, stack_tables=stack, fused_kind="rowwise_adagrad",
                    grouped_a2a=True)
        tables = _tables(specs, 0, stack_tables=stack, fused_kind="rowwise_adagrad")
        feats = _ids(5, 1)
        grads = _grads(feats, 9)
        cases[f"f32_stack{int(stack)}"] = dict(
            fn="grouped", mesh=MESH, specs=_tspecs(specs), grouped=True,
            stack_tables=stack, kind="rowwise_adagrad", tables=tables,
            features=feats, grads=grads, lr=LR, step=0)
        jax_jobs[f"f32_stack{int(stack)}"] = (jc, _padded(jc, tables), feats, grads)
    # 26 tables, one group: the collective counts
    specs26 = _specs(26)
    f26 = _ids(26, 2, pad=False)
    cases["t26"] = dict(fn="grouped", mesh=MESH, specs=_tspecs(specs26),
                        grouped=True, kind="rowwise_adagrad",
                        tables=_tables(specs26, 1), features=f26,
                        grads=_grads(f26, 3), lr=LR, step=0)
    # a replicated table beside the group
    specs_r = _specs(3) + [dict(name="r0", num_embeddings=16, embedding_dim=D,
                                features=("fr",), sharding="replicated",
                                init_scale=0.1, dtype="float32", fused=False)]
    feats_r = dict(_ids(3, 4), fr=(np.arange(B) % 16).astype(np.int32))
    cases["replicated"] = dict(
        fn="grouped", mesh=MESH, specs=_tspecs(specs_r), grouped=True,
        kind="rowwise_adagrad", features=feats_r, tables=_tables(specs_r, 2))
    cases["capacity"] = dict(_capacity_case(), tables=_tables(_specs(2), 3))
    # int8: plain t0, t1 and fused t2 in one (8, int8) group
    specs8 = _specs(3, dtype="int8", fused=(2,))
    jc8 = _jcoll(specs8, jmesh, fused_kind="adam", grouped_a2a=True)
    t8 = _tables(specs8, 4)
    f8 = _ids(3, 5)
    upd = {f"f{i}": f8[f"f{i}"] for i in range(2)}
    g8 = _grads(upd, 6)
    per_table = {f"t{i}": (f8[f"f{i}"], g8[f"f{i}"]) for i in range(2)}
    cases["int8"] = dict(fn="grouped", mesh=MESH, specs=_tspecs(specs8),
                         grouped=True, kind="adam", tables=t8, features=f8,
                         grads=g8, lr=LR, step=3, sr=True,
                         per_table_update=per_table)
    cases["int8_modes"] = dict(fn="lookup_modes", mesh=MESH, specs=_tspecs(specs8),
                               tables=t8, features=f8)
    cases["steps"] = _twotower_case()
    cases.update(fit)
    ranks.send(cases)
    want = _jax_side(jmesh, jax_jobs, (jc8, _padded(jc8, t8), f8, g8, per_table))
    return cases, want, ranks.wait()


def _placed(feats, axis, mesh):
    return {f: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P(axis)))
            for f, v in feats.items()}


def _jax_side(jmesh, f32_jobs, int8_job):
    """Every JAX result in one jitted program: the grouped rowwise_adagrad
    update of each f32 case, and the int8 case's psum, alltoall and grouped
    lookups, its per-table (``sparse_update``) and grouped updates."""
    jc8, t8, f8, g8, per_table = int8_job
    jc8_pt = JColl(list(jc8.specs.values()), mesh=jmesh, fused_kind="adam")
    opt_r = jopt("rowwise_adagrad", lr=LR)
    opt_a = jopt("adam", lr=LR)
    upd8 = {f: f8[f] for f in g8}

    def program(f32_in, t8_, ids_data, ids_model, upd_ids, g8_, pt):
        out = {}
        for (name, (jc, _, _, _)), (tables, ids, grads) in zip(
                f32_jobs.items(), f32_in):
            slots = {a: opt_r.init(t) for a, t in tables.items()}
            out[name] = jc.grouped_update(opt_r, tables, slots, ids, grads)[0]
        out["int8_psum"] = jc8_pt.lookup(t8_, ids_data, mode="psum")
        out["int8_alltoall"] = jc8_pt.lookup(t8_, ids_model, mode="alltoall")
        out["int8_grouped"] = jc8.lookup(t8_, ids_model, mode="alltoall")
        slots = {a: opt_a.init(t) for a, t in t8_.items()
                 if not a.startswith("__qscale__/")}
        gt, gs = jc8.grouped_update(opt_a, t8_, slots, upd_ids, g8_,
                                    sr_key=jq.sr_key(3, "__grouped_update__"))
        out["int8_grouped_update"] = gt
        out["int8_grouped_slots"] = gs
        per = {}
        for name, (ids, g) in pt.items():
            qn = "__qscale__/" + name
            t, s, q = jc8_pt.sparse_update(
                opt_a, name, t8_[name], slots[name], ids, g,
                sr_key=jq.sr_key(3, name), qscale=t8_[qn])
            per[name], per[qn], per[name + "/slots"] = t, q, s
        out["int8_per_table"] = per
        return out

    f32_in = [(v[1], _placed(v[2], "model", jmesh),
               {f: jax.device_put(jnp.asarray(g), NamedSharding(jmesh, P("model", None)))
                for f, g in v[3].items()}) for v in f32_jobs.values()]
    got = jax.jit(program)(
        f32_in, t8, _placed(f8, "data", jmesh), _placed(f8, "model", jmesh),
        _placed(upd8, "model", jmesh),
        {f: jax.device_put(jnp.asarray(g), NamedSharding(jmesh, P("model", None)))
         for f, g in g8.items()},
        per_table)
    return jax.tree.map(np.asarray, got)


def _rank(name):
    _, _, res = _setup()
    return [r[name] for r in res]


def _trim(want, got):
    """A JAX array with the reference's mesh padding cut to the gathered
    single-device rows."""
    return np.asarray(want)[:got.shape[0]]


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("stack", [False, True])
def test_grouped_forward_equals_per_table_bitwise(stack):
    cases, _, _ = _setup()
    feats = cases[f"f32_stack{stack:d}"]["features"]
    for r in _rank(f"f32_stack{stack:d}"):
        for f, ids in feats.items():
            pad = ids < 0
            np.testing.assert_array_equal(r["grouped"][f][~pad],
                                          r["per_table"][f][~pad], err_msg=f)
            assert (r["grouped"][f][pad] == 0).all()
            if not stack:  # no row offsets: both read zeros at padding
                np.testing.assert_array_equal(r["grouped"][f], r["per_table"][f])


def test_all_to_all_counts_at_26_tables():
    """Exact counts: 2 for the grouped lookup (ids out, vectors back), 2
    per table for the per-table one, 2 for the grouped update."""
    for r in _rank("t26"):
        assert r["grouped_a2a"] == 2
        assert r["per_table_a2a"] == 2 * 26
        assert r["update_a2a"] == 2
        for f in r["grouped"]:
            np.testing.assert_array_equal(r["grouped"][f], r["per_table"][f])


def test_grouped_routes_around_replicated_tables():
    for r in _rank("replicated"):
        assert r["grouped_a2a"] == 2  # the replicated feature takes none
        for f in r["grouped"]:
            np.testing.assert_array_equal(r["grouped"][f], r["per_table"][f],
                                          err_msg=f)


# ------------------------------------------------------------------- update


@pytest.mark.parametrize("stack", [False, True])
def test_grouped_update_matches_sequential_reference(stack):
    """Bitwise the port's ``opt.update`` per feature, in feature order, on
    the whole (unsharded) arrays."""
    from tdfo_tpu_torch.parallel.embedding import (
        EmbeddingSpec,
        ShardedEmbeddingCollection,
    )

    cases, _, _ = _setup()
    case = cases[f"f32_stack{stack:d}"]
    coll = ShardedEmbeddingCollection([EmbeddingSpec(**s) for s in case["specs"]],
                                      stack_tables=stack, fused_kind="rowwise_adagrad")
    opt = sparse_optimizer("rowwise_adagrad", lr=LR)
    ref_t = tables_from_numpy(case["tables"])
    ref_s = {a: opt.init(t) for a, t in ref_t.items()}
    for f, ids in case["features"].items():
        aname, _, off = coll.resolve(f)
        gid = torch.from_numpy(np.where(ids >= 0, ids + off, -1))
        opt.update(ref_t[aname], ref_s[aname], gid, torch.from_numpy(case["grads"][f]),
                   embedding_dim=D)
    for r in _rank(f"f32_stack{stack:d}"):
        for a, got in r["tables"].items():
            np.testing.assert_array_equal(got, to_numpy(ref_t[a])[:got.shape[0]],
                                          err_msg=a)
            for x, y in zip(r["slots"][a], ref_s[a]):
                np.testing.assert_array_equal(x, to_numpy(y)[:x.shape[0]])


@pytest.mark.parametrize("stack", [False, True])
def test_grouped_update_matches_jax(stack):
    """The JAX package's ``grouped_update`` at world 2, at the optimizer
    rung (its rowwise_adagrad math contracts into fused multiply-adds)."""
    _, want, _ = _setup()
    for r in _rank(f"f32_stack{stack:d}"):
        for a, got in r["tables"].items():
            np.testing.assert_allclose(got, _trim(want[f"f32_stack{stack:d}"][a], got),
                                       rtol=RTOL, atol=ATOL, err_msg=a)


def test_capacity_drops_the_same_ids_forward_and_backward():
    """All ids on shard 0 under capacity factor 0.5: one cap over the
    combined stream of both tables (not a cap a table), the overflow count
    the hand-computed one; the stable sort keeps the stream's first ``cap``
    ids of each rank, all of ``f0``, so ``f0`` reads rows there and ``f1``
    zeros, and the update moves the one row (id 0) of ``t0`` and none of
    ``t1``: the ids dropped forward are those dropped backward."""
    cases, _, _ = _setup()
    n_local = 2 * B // M
    cap = min(n_local, -(-int(0.5 * n_local / M) // 8) * 8)
    assert cap < B // M
    tables = cases["capacity"]["tables"]
    for r in _rank("capacity"):
        assert r["overflow"] == r["dropped"] == M * (n_local - cap)
        kept = {f: int((np.abs(v).sum(-1) > 0).sum()) for f, v in r["grouped"].items()}
        assert kept == {"f0": M * cap, "f1": 0}
        moved = {a: int((np.abs(r["tables"][a] - tables[a][:r["tables"][a].shape[0]])
                         .sum(-1) > 0).sum()) for a in r["tables"]}
        assert moved == {"t0": 1, "t1": 0}


# -------------------------------------------------------------- the steps


def test_pipelined_matches_eager_grouped_bitwise():
    for r in _rank("steps"):
        e, p = r["eager"], r["pipelined"]
        assert p["losses"] == e["losses"] and len(e["losses"]) == 4
        assert p["step"] == e["step"] == 4
        for a in e["tables"]:
            np.testing.assert_array_equal(p["tables"][a], e["tables"][a], err_msg=a)
            for x, y in zip(p["slots"][a], e["slots"][a]):
                np.testing.assert_array_equal(x, y)
        # the fat stack's kernel ran once a step in both
        assert p["fat_runs"] == e["fat_runs"] == 4


def test_pipelined_step_counts_four_all_to_all():
    """A pipelined step: the next batch's ids (1), the carried batch's
    vectors (1) and its update (ids + grads, 2); ``prime`` the ids only,
    ``flush`` the rest.  The eager grouped step: the same 4."""
    for r in _rank("steps"):
        assert r["pipelined"]["a2a"] == [4, 4, 4]
        assert (r["prime_a2a"], r["flush_a2a"]) == (1, 3)
        assert r["eager"]["a2a"] == [4] * 4


def test_grouped_step_equals_per_table_step():
    """Same forward, and each owner sums its rows' grads in global batch
    order either way: the eager grouped and per-table steps agree bitwise."""
    for r in _rank("steps"):
        assert r["eager"]["losses"] == r["per_table"]["losses"]
        for a in r["eager"]["tables"]:
            np.testing.assert_array_equal(r["eager"]["tables"][a],
                                          r["per_table"]["tables"][a], err_msg=a)


# ------------------------------------------------------------------- int8


def test_int8_lookups_match_jax_bitwise():
    """psum and alltoall (decoded at the owner) and grouped (codes and
    sidecar rows on the wire, decoded after it; the fused member on the
    identity grid, the payload f32) lookups: the JAX package's values."""
    _, want, _ = _setup()
    for r_modes, r in zip(_rank("int8_modes"), _rank("int8")):
        for mode in ("psum", "alltoall"):
            for f, v in r_modes[mode].items():
                np.testing.assert_array_equal(v, want[f"int8_{mode}"][f],
                                              err_msg=f"{mode} {f}")
        for f, v in r["grouped"].items():
            np.testing.assert_array_equal(v, want["int8_grouped"][f], err_msg=f)
        assert r["grouped_a2a"] == 3  # ids, codes as f32, their (scale, offset)


def _narrow_rung(got, want, before, qs_got, qs_want, what):
    """int8 codes within one grid step, sidecars at the optimizer rung,
    untouched rows (sidecar unchanged in both) bitwise."""
    want, qs_want = want[:got.shape[0]], qs_want[:got.shape[0]]
    np.testing.assert_allclose(qs_got, qs_want, rtol=RTOL, atol=ATOL, err_msg=what)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, what
    touched = np.any(want != before[:got.shape[0]], axis=-1)
    np.testing.assert_array_equal(got[~touched], want[~touched], err_msg=what)
    assert touched.sum() > 0


def test_int8_updates_match_jax_at_the_narrow_rung():
    _, want, _ = _setup()
    cases, _, _ = _setup()
    t8 = cases["int8"]["tables"]
    for r in _rank("int8"):
        for name in ("t0", "t1"):
            qn = "__qscale__/" + name
            # per-table: the JAX package updates the global array
            _narrow_rung(r["per_table_tables"][name], want["int8_per_table"][name],
                         t8[name], r["per_table_tables"][qn],
                         want["int8_per_table"][qn], f"per-table {name}")
            # grouped: the same key folds (table id, model index) in both
            _narrow_rung(r["tables"][name], want["int8_grouped_update"][name],
                         t8[name], r["tables"][qn],
                         want["int8_grouped_update"][qn], f"grouped {name}")
            for x, y in zip(r["slots"][name], want["int8_grouped_slots"][name]):
                np.testing.assert_allclose(x, np.asarray(y)[:x.shape[0]] if x.ndim
                                           else y, rtol=RTOL, atol=ATOL)
        assert r["update_a2a"] == 2


# ------------------------------------------------------------------ trainer


def _fit_bodies():
    from tdfo_tpu_torch.data.ctr_preprocessing import run_ctr_preprocessing
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads

    root = Path(tempfile.mkdtemp(prefix="grouped_fit_"))
    write_synthetic_goodreads(root / "ctr", n_users=400)
    size_map = run_ctr_preprocessing(root / "ctr")

    def body(name, **kw):
        b = dict(data_dir=str(root / "ctr"), model="twotower", model_parallel=True,
                 n_epochs=1, learning_rate=3e-4, weight_decay=1e-4, embed_dim=8,
                 per_device_train_batch_size=256, per_device_eval_batch_size=1024,
                 shuffle_buffer_size=500, log_every_n_steps=1,
                 fused_table_threshold=0, size_map=size_map, seed=11,
                 lookup_mode="alltoall", mesh={"data": 1, "model": 2},
                 checkpoint_dir=str(root / name), checkpoint_every_n_steps=3,
                 embeddings={"grouped_a2a": True}, train={"pipeline_overlap": True})
        b.update(kw)
        return b

    return {
        "fit_eager": dict(fn="fit", body=body("eager", train={})),
        "fit_pipe": dict(fn="fit", body=body("pipe")),
        "fit_pipe_kill": dict(fn="fit", kill_at=6, body=body("pipe_kill")),
        "fit_int8": dict(fn="fit", body=body(
            "int8", train={}, a2a_capacity_factor=2.0, fused_table_threshold=100,
            per_device_train_batch_size=1024,
            embeddings={"grouped_a2a": True, "table_dtype": "int8"})),
    }


def test_pipelined_fit_killed_and_resumed_is_bitwise():
    import json

    cases, _, res = _setup()
    recs = [json.loads(x) for x in (Path(cases["fit_pipe_kill"]["body"]
                                         ["checkpoint_dir"]) / "metrics.jsonl")
            .read_text().splitlines()]
    assert any(r.get("resumed_mid_epoch") == 0 and r.get("step") == 3 for r in recs)
    for r in res:
        whole, kill = r["fit_pipe"], r["fit_pipe_kill"]
        assert whole["step"] > 6 and kill["step"] == whole["step"]
        assert kill["metrics"] == whole["metrics"]
        for k, v in whole["tables"].items():
            np.testing.assert_array_equal(kill["tables"][k], v, err_msg=k)


def _log(case):
    import json

    cases, _, _ = _setup()
    path = Path(cases[case]["body"]["checkpoint_dir"]) / "metrics.jsonl"
    return [json.loads(x) for x in path.read_text().splitlines()]


def test_pipelined_fit_equals_the_eager_grouped_fit():
    """The same run with the pipeline off: the logged train losses, the
    epoch's mean loss, step count and train AUC (the pipelined loop folds
    each batch's labels with its logits, one call later) and the final
    tables, bitwise.  The last batch trains in the epoch's flush, after
    the loop's log check, so its loss is not logged on its own (as in the
    reference); the epoch's mean counts it."""
    _, _, res = _setup()
    losses = lambda recs: [r["train_loss"] for r in recs if "train_loss" in r]  # noqa: E731
    epoch = lambda recs: [(r["train_loss_epoch"], r["steps"], r["train_auc"])  # noqa: E731
                          for r in recs if "train_loss_epoch" in r]
    pipe, eager = _log("fit_pipe"), _log("fit_eager")
    assert losses(pipe) == losses(eager)[:-1] and len(losses(pipe)) > 6
    assert epoch(pipe) == epoch(eager) and len(epoch(pipe)) == 1
    for r in res:
        assert r["fit_pipe"]["metrics"] == r["fit_eager"]["metrics"]
        for k, v in r["fit_eager"]["tables"].items():
            np.testing.assert_array_equal(r["fit_pipe"]["tables"][k], v, err_msg=k)


def test_pipelined_step_refuses_without_a_grouped_mesh():
    from tdfo_tpu_torch.parallel.embedding import (
        EmbeddingSpec,
        ShardedEmbeddingCollection,
    )
    from tdfo_tpu_torch.train.sparse_step import make_pipelined_sparse_train_step

    specs = [EmbeddingSpec(**s) for s in _tspecs(_specs(2))]
    for coll in (ShardedEmbeddingCollection(specs),
                 ShardedEmbeddingCollection(specs, grouped_a2a=True)):
        with pytest.raises(ValueError, match="grouped_a2a collection on a device mesh"):
            make_pipelined_sparse_train_step(coll, lambda embs, batch: 0.0)


def test_int8_world_two_checkpoint_restores_at_world_one():
    """The int8 run's checkpoint holds the single-device layout, sidecars
    included: one rank restores it bitwise."""
    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.interop import gather_to_numpy
    from tdfo_tpu_torch.train.trainer import Trainer

    cases, _, res = _setup()
    body = {k: v for k, v in cases["fit_int8"]["body"].items() if k != "mesh"}
    tr = Trainer(read_configs(None, **body), device="cpu")
    step, _ = tr.restore_latest()
    assert step == res[0]["fit_int8"]["step"] > 0
    got = gather_to_numpy(tr.coll, tr.state.tables)[0]
    assert got.keys() == res[0]["fit_int8"]["tables"].keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, res[0]["fit_int8"]["tables"][k], err_msg=k)


def test_int8_grouped_config_trains_at_world_two():
    import json
    import math

    cases, _, res = _setup()
    recs = [json.loads(x) for x in (Path(cases["fit_int8"]["body"]
                                         ["checkpoint_dir"]) / "metrics.jsonl")
            .read_text().splitlines()]
    # the grouped overflow count rides every log line (0 at 2x capacity)
    assert [x["a2a_overflow"] for x in recs if "a2a_overflow" in x] == [
        0] * sum("train_loss" in x for x in recs)
    for r in res:
        m = r["fit_int8"]["metrics"]
        assert math.isfinite(m["eval_loss"]) and 0.0 <= m["auc"] <= 1.0
        tabs = r["fit_int8"]["tables"]
        # fat int8 lines (user, item) beside plain int8 tables with sidecars
        assert any(v.ndim == 3 for v in tabs.values())
        assert any(k.startswith("__qscale__/") for k in tabs)
        assert all(v.dtype == np.int8 for k, v in tabs.items()
                   if not k.startswith("__qscale__/"))
