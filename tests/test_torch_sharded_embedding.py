"""The sharded embedding collection, port against the JAX package, on gloo
ranks (``tests/torch_dist_worker.py``): world 2 is the reference's mesh data
1 x model 2 on two spoofed CPU devices, world 4 its data 2 x model 2 on
four.  Each world size is spawned once; every case runs in it.

Held: ``gspmd``, ``psum`` and ``alltoall`` lookups of row-, table- and
column-sharded tables (fat lines included) with 1D and 2D ids, exactly the
reference's vectors; skewed ids; the padded vocab and each rank's shard
shape; the gradients of the psum lookup (and of the gspmd and alltoall
ones, of row, table and column tables) equal to the count matrix;
alltoall's capacity
factor (dropped ids read zeros and ``a2a_overflow`` counts them; at world
2 as many as the reference drops; at world 4 the port splits the alltoall
ids over data x model where the reference splits them over model only, so
its buckets hold fewer ids); the explicit modes refusing column sharding; a
row-sharded fat ``sparse_update`` in f32 (bitwise the single-device
update, and the reference's sharded update at the optimizer rung) and bf16
(one bf16 ulp of the reference's, whose bits fold the same shard index);
``init`` under a mesh giving each rank the single-device init's rows; a
checkpoint's gather (``global_arrays(root_only=True)``) reaching rank 0
alone, on its host, bitwise the all-gather, and the restore template
(``global_template``) holding no memory for the sharded arrays.
"""

import functools

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
from tdfo_tpu.parallel.embedding import EmbeddingSpec as JSpec
from tdfo_tpu.parallel.embedding import ShardedEmbeddingCollection as JColl
from tdfo_tpu_torch.interop import TOL, tables_from_numpy, to_numpy, tree_from_numpy
from tdfo_tpu_torch.ops.sparse import sparse_optimizer
from tdfo_tpu_torch.parallel.embedding import EmbeddingSpec as TSpec
from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection as TColl

D = 8
MESHES = {2: (1, 2), 4: (2, 2)}
SPECS = {
    "row": [dict(name="item", num_embeddings=67, embedding_dim=D,
                 features=("item",), sharding="row", init_scale=0.5),
            dict(name="fat", num_embeddings=45, embedding_dim=D,
                 features=("fat",), sharding="row", init_scale=0.5, fused=True)],
    "table": [dict(name=f"t{i}", num_embeddings=10 + 3 * i, embedding_dim=D,
                   features=(f"f{i}",), sharding="table", init_scale=0.5)
              for i in range(3)],
    "column": [dict(name="item", num_embeddings=40, embedding_dim=D,
                    features=("item",), sharding="column", init_scale=0.5)],
}
MODES = ("gspmd", "psum", "alltoall")
GRAD_CASES = (("row", "gspmd"), ("row", "alltoall"), ("table", "psum"),
              ("table", "alltoall"), ("column", "gspmd"))


def _jmesh(world):
    d, m = MESHES[world]
    return make_mesh(JMeshSpec(data=d, model=m, seq=1), devices=jax.devices()[:world])


def _jcoll(sharding, mesh, **kw):
    return JColl([JSpec(**s) for s in SPECS[sharding]], mesh=mesh, **kw)


def _features(sharding, rng, shape):
    out = {}
    for s in SPECS[sharding]:
        for f in s["features"]:
            out[f] = rng.integers(0, s["num_embeddings"], shape).astype(np.int32)
    return out


def _placed(feats, mode, mesh):
    axis = {"psum": "data", "alltoall": "model"}.get(mode)
    return {f: (jax.device_put(jnp.asarray(v), NamedSharding(mesh, P(axis)))
                if axis else jnp.asarray(v)) for f, v in feats.items()}


def _jlookup(coll, tables, feats, mode, mesh):
    out = jax.jit(lambda t, i: coll.lookup(t, i, mode=mode))(
        tables, _placed(feats, mode, mesh))
    return {f: np.asarray(v) for f, v in out.items()}


def _jlookups(jobs, mesh):
    """``{name: lookup}`` of every ``(name, coll, tables, feats, mode)`` job,
    all in one jitted program (one compile for the lot)."""
    fixed = [(c, m) for _, c, _, _, m in jobs]
    run = jax.jit(lambda ts, ids: [c.lookup(t, i, mode=m)
                                   for (c, m), t, i in zip(fixed, ts, ids)])
    outs = run([t for _, _, t, _, _ in jobs],
               [_placed(f, m, mesh) for _, _, _, f, m in jobs])
    return {job[0]: {f: np.asarray(v) for f, v in out.items()}
            for job, out in zip(jobs, outs)}


def _dense_rows(jc, tables, feats):
    """Each feature's rows of its global array (fat lines: the table lanes
    of the row's slot)."""
    out = {}
    for f, ids in feats.items():
        aname, spec, off = jc.resolve(f)
        t = tables[aname]
        if t.ndim == 3:
            lay = jc.fat_layout_for(aname)
            t = t.reshape(t.shape[0] * lay.r, -1)[:, :spec.embedding_dim]
        out[f] = t[ids + off]
    return out


@functools.lru_cache(maxsize=None)
def _setup(world):
    """The JAX side of every case and the ranks' results, once per world.
    The ranks start first and get the cases once all are built; the JAX
    programs (``lookups``, one compile; ``later``) run while the ranks run
    them."""
    ranks = Ranks(world, _tmp(world))
    mesh = _jmesh(world)
    rng = np.random.default_rng(world)
    cases, want, later, lookups = {}, {}, {}, []
    jtables = {}
    for sharding in SPECS:
        jc = _jcoll(sharding, mesh)
        jt = jc.init(jax.random.key(3))
        jtables[sharding] = (jc, jt)
        tables = {k: np.asarray(v) for k, v in jt.items()}
        for mode in MODES:
            for dims, shape in (("1d", (32,)), ("2d", (8, 5))):
                feats = _features(sharding, rng, shape)
                name = f"lookup_{sharding}_{mode}_{dims}"
                case = dict(fn="lookup", mesh=MESHES[world], specs=SPECS[sharding],
                            tables=tables, features=feats, mode=mode)
                if sharding == "column" and mode != "gspmd":
                    case["expect"] = "ValueError"
                    if dims == "1d":
                        with pytest.raises(ValueError, match="requires row/table"):
                            _jlookup(jc, jt, feats, mode, mesh)
                elif mode == "gspmd" or (mode, dims) == ("alltoall", "2d"):
                    # the reference's gspmd lookup, and its alltoall on 2D
                    # ids (flattened), are its global table's rows
                    # (tests/test_embedding_collection.py pins both)
                    want[name] = _dense_rows(jc, tables, feats)
                else:
                    lookups.append((name, jc, jt, feats, mode))
                cases[name] = case
        want[f"shapes_{sharding}"] = {
            k: v.addressable_shards[0].data.shape for k, v in jt.items()}
    # skew: every id on shard 0, exact capacity; then a capacity factor
    # that drops ids
    jc, jt = jtables["row"]
    tables = {k: np.asarray(v) for k, v in jt.items()}
    skew = {"item": np.zeros(32, np.int32), "fat": np.full(32, 3, np.int32)}
    cases["skew"] = dict(fn="lookup", mesh=MESHES[world], specs=SPECS["row"],
                         tables=tables, features=skew, mode="alltoall")
    lookups.append(("skew", jc, jt, skew, "alltoall"))
    cjc = _jcoll("row", mesh, a2a_capacity_factor=0.5)
    over = {"item": np.where(rng.random(64) < 0.8, 1, 60).astype(np.int32),
            "fat": rng.integers(0, 45, 64).astype(np.int32)}
    cases["overflow"] = dict(fn="lookup", mesh=MESHES[world], specs=SPECS["row"],
                             tables=tables, features=over, mode="alltoall", cf=0.5)
    lookups.append(("skew_free", jc, jt, over, "alltoall"))
    placed = {f: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("model")))
              for f, v in over.items()}
    later["overflow_count"] = lambda jt=jt: int(jax.jit(cjc.a2a_overflow)(jt, placed))
    # the psum gradient: the count matrix of the ids
    gfeat = {"item": rng.integers(0, 67, 16).astype(np.int32),
             "fat": rng.integers(0, 45, 16).astype(np.int32)}
    cases["grad_psum"] = dict(fn="grad", mesh=MESHES[world],
                              specs=SPECS["row"][:1], tables={"item": tables["item"]},
                              features={"item": gfeat["item"]}, mode="psum")
    count = np.zeros((67, D), np.float32)
    np.add.at(count, gfeat["item"], 1.0)
    want["grad_psum"] = count
    # every other mode's gradient is the count matrix too (the collectives'
    # backwards: all-to-all back, own columns, identity after the psum)
    for sharding, mode in GRAD_CASES:
        jc, jt = jtables[sharding]
        specs = [sp for sp in SPECS[sharding] if not sp.get("fused")]
        feats = {f: rng.integers(0, sp["num_embeddings"], 16).astype(np.int32)
                 for sp in specs for f in sp["features"]}
        aname = "__stack_8" if sharding == "table" else "item"
        count = np.zeros(np.asarray(jt[aname]).shape, np.float32)
        for f, ids in feats.items():
            np.add.at(count, ids + jc.resolve(f)[2], 1.0)
        cases[f"grad_{sharding}_{mode}"] = dict(
            fn="grad", mesh=MESHES[world], specs=specs, mode=mode, features=feats,
            tables={aname: np.asarray(jt[aname])})
        want[f"grad_{sharding}_{mode}"] = (aname, count)
    # row-sharded fat sparse_update, f32 and bf16
    for dt in ("float32", "bfloat16"):
        spec = dict(SPECS["row"][1], dtype=getattr(torch, dt))
        jspec = JSpec(**dict(SPECS["row"][1], dtype=getattr(jnp, dt)))
        jcu = JColl([jspec], mesh=mesh)
        jtu = jcu.init(jax.random.key(5))
        from tdfo_tpu.ops.quant import sr_key as j_sr_key
        from tdfo_tpu.ops.sparse import sparse_optimizer as j_opt

        ids = rng.integers(0, 45, 64).astype(np.int32)
        ids[::5] = ids[1::5][: len(ids[::5])]
        g = rng.standard_normal((64, D)).astype(np.float32)
        jopt = j_opt("adam", lr=1e-2, weight_decay=1e-4)
        slots = (jnp.zeros((), jnp.int32),)
        key = j_sr_key(7, "fat") if dt == "bfloat16" else None

        def update(jcu=jcu, jtu=jtu, jopt=jopt, slots=slots, key=key, ids=ids, g=g):
            new, _ = jax.jit(lambda t, s, i, gg: jcu.sparse_update(
                jopt, "fat", t, s, i, gg, sr_key=key))(jtu["fat"], slots,
                                                      jnp.asarray(ids), jnp.asarray(g))
            return np.asarray(jtu["fat"]), np.asarray(new), ids, g

        later[f"update_{dt}"] = update
        cases[f"update_{dt}"] = dict(
            fn="update", mesh=MESHES[world], specs=[spec], lr=1e-2, wd=1e-4,
            tables={"fat": np.asarray(jtu["fat"])},
            slots={"fat": (np.zeros((), np.int32),)},
            updates={"fat": (ids, g)}, step=7, sr=dt == "bfloat16")
    # init under the mesh: each rank keeps the single-device init's rows;
    # a checkpoint's gather of those tables and their slots to rank 0
    for sharding in ("row", "column"):
        for what in ("init", "ckpt_gather"):
            cases[f"{what}_{sharding}"] = dict(fn=what, mesh=MESHES[world],
                                               specs=SPECS[sharding], seed=9)
    ranks.send(cases)
    want.update(_jlookups(lookups, mesh))
    want.update({k: f() for k, f in later.items()})
    return cases, want, ranks.wait()


def _tmp(world):
    import tempfile
    from pathlib import Path

    return Path(tempfile.mkdtemp(prefix=f"sharded_emb_{world}_"))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("sharding", list(SPECS))
def test_lookups_match_the_reference(world, sharding):
    cases, want, results = _setup(world)
    for mode in MODES:
        for dims in ("1d", "2d"):
            name = f"lookup_{sharding}_{mode}_{dims}"
            for r, res in enumerate(results):
                got = res[name]
                if cases[name].get("expect"):
                    assert got["raised"] == "ValueError", (name, got)
                    assert "requires row/table sharding" in got["message"]
                    continue
                for f, v in want[name].items():
                    np.testing.assert_array_equal(got["out"][f], v,
                                                  err_msg=f"{name} {f} rank {r}")
                    tbl = cases[name]["tables"]
                    # and the dense rows of the global table
                    aname = "__stack_8" if sharding == "table" else f
                    if sharding != "table" and f != "fat":
                        np.testing.assert_array_equal(
                            got["out"][f], tbl[aname][cases[name]["features"][f]])


@pytest.mark.parametrize("world", [2, 4])
def test_vocab_padding_and_shard_shapes(world):
    cases, want, results = _setup(world)
    for sharding in SPECS:
        for r, res in enumerate(results):
            shapes = res[f"lookup_{sharding}_gspmd_1d"]["shapes"]
            assert shapes == {k: tuple(v) for k, v in want[f"shapes_{sharding}"].items()}
    # the global padded rows: 67 -> 68 (2 shards), fat 45 -> whole lines x 2
    tc = TColl([TSpec(**s) for s in SPECS["row"]])
    assert tc.array_rows("item") == 67


@pytest.mark.parametrize("world", [2, 4])
def test_alltoall_skew_and_capacity_overflow(world):
    cases, want, results = _setup(world)
    for res in results:
        for f, v in want["skew"].items():
            np.testing.assert_array_equal(res["skew"]["out"][f], v)
        got = res["overflow"]
        zero_rows = sum(int((np.abs(v).sum(-1) == 0).sum())
                        for v in got["out"].values())
        assert zero_rows == got["overflow"] == got["dropped"] > 0
        if world == 2:
            assert got["overflow"] == want["overflow_count"]
        # which ids of a full bucket drop is the owner sort's choice (the
        # reference's sort is unstable, the port's stable): every row is
        # the exact lookup's or a dropped zero
        for f, v in want["skew_free"].items():
            kept = np.abs(got["out"][f]).sum(-1) != 0
            np.testing.assert_array_equal(got["out"][f][kept], v[kept])
        assert 0.0 < got["fill"] <= 1.0


@pytest.mark.parametrize("world", [2, 4])
def test_psum_gradient_is_the_count_matrix(world):
    _, want, results = _setup(world)
    for res in results:
        np.testing.assert_array_equal(res["grad_psum"]["grad"]["item"][:67],
                                      want["grad_psum"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("sharding,mode", GRAD_CASES)
def test_lookup_gradients_are_the_count_matrix(world, sharding, mode):
    _, want, results = _setup(world)
    aname, count = want[f"grad_{sharding}_{mode}"]
    for res in results:
        got = res[f"grad_{sharding}_{mode}"]["grad"][aname]
        np.testing.assert_array_equal(got, count[:got.shape[0]])
        assert not count[got.shape[0]:].any()  # padding rows take nothing


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_row_sharded_fat_update(world, dt):
    cases, want, results = _setup(world)
    before, jnew, ids, g = want[f"update_{dt}"]
    case = cases[f"update_{dt}"]
    for res in results:
        got = res[f"update_{dt}"]
        assert got["fat_runs"] == 1  # the kernel's plain version, on the shard
        t = got["tables"]["fat"]
        if dt == "float32":
            np.testing.assert_allclose(t, jnew[:t.shape[0]], rtol=TOL["optimizer"][0],
                                       atol=TOL["optimizer"][1])
            # bitwise the single-device update of the same table
            coll = TColl([TSpec(**case["specs"][0])])
            one = tables_from_numpy({"fat": before[:t.shape[0]]})
            opt = sparse_optimizer("adam", lr=1e-2, weight_decay=1e-4)
            coll.sparse_update(opt, "fat", one["fat"],
                               tree_from_numpy((np.zeros((), np.int32),)),
                               torch.from_numpy(ids), torch.from_numpy(g))
            np.testing.assert_array_equal(t, to_numpy(one["fat"]))
        else:
            # one bf16 ulp of the reference's sharded update
            jt = jnew[:t.shape[0]].astype(np.float32)
            ulp = np.abs(jt) * 2.0 ** -7 + 1e-30
            assert np.all(np.abs(t - jt) <= ulp), float(np.abs(t - jt).max())


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("sharding", ["row", "column"])
def test_sharded_init_is_the_single_device_init(world, sharding):
    _, _, results = _setup(world)
    want = TColl([TSpec(**s) for s in SPECS[sharding]]).init(9, device="cpu")
    for res in results:
        got = res[f"init_{sharding}"]["tables"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], to_numpy(v), err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("sharding", ["row", "column"])
def test_checkpoint_gather_reaches_rank_zero_only(world, sharding):
    _, _, results = _setup(world)
    got = results[0][f"ckpt_gather_{sharding}"]
    assert got["root"] == "all" and got["bitwise"] and got["on_host"]
    assert got["template"] and got["stand_ins"] and set(got["stand_ins"]) == {1}
    for res in results[1:]:
        # ranks off rank 0's model line take no part; those on it keep
        # none of the sharded arrays
        assert res[f"ckpt_gather_{sharding}"]["root"] in (None, [])
