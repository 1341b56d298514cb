"""Serving bundles of the PyTorch port against ``tdfo_tpu``'s, on the CPU.

Held bitwise, digest included: the bundles both packages export from the
same state (its arrays carried across), for a DMP TwoTower with a fat
stack, a DLRM stack (``stack_tables``, a rowwise fat stack and a plain
stack, the ``dedup_lookup`` configuration), an int8 + hot/cold state with
an unflushed update cache, and the dense-regime TwoTower (Bert4Rec:
``test_torch_serve_seq.py``); the cast policies (bf16 bits, the GPU's f16
policy shipping f32); and the corpus store.  The int8 cache state is held
against the reference's export of the same state FLUSHED: the reference's
overlay of an unflushed cache copies int8 codes without their grid
(``ROADMAP.md`` Queue C), the port's copies both, as the flush does.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_serve_helpers import (
    CAT_COLS,
    CONT_COLS,
    DIM,
    SIZE_MAP,
    StubMesh,
    assert_same_bundle,
    jax_twotower,
    port_twotower,
    twotower_export_kw,
)

from tdfo_tpu.serve import export as jexp
from tdfo_tpu_torch.interop import flax_params_from_module
from tdfo_tpu_torch.serve import export as texp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(tmp_path, jkw, tkw, common):
    ja = jexp.export_bundle(tmp_path / "jax", **common, **jkw)
    ta = texp.export_bundle(tmp_path / "torch", **common, **tkw)
    assert_same_bundle(ja, ta)
    return ja, ta


@pytest.mark.parametrize("fused", [200, None], ids=["fat_stack", "plain"])
def test_dmp_twotower_bundle_is_the_reference_bundle(tmp_path, fused):
    jc, _, jt, jd = jax_twotower(fused_threshold=fused, seed=3)
    tc, tt, tb = port_twotower(jt, jd, fused_threshold=fused)
    if fused:
        assert any(k.startswith("__fatstack_") for k in tt)
    ja, _ = _both(tmp_path, dict(coll=jc, tables=jt, dense_params=jd),
                  dict(coll=tc, tables=tt, dense_params=tb),
                  dict(twotower_export_kw(), step=7))
    b = texp.load_bundle(ja, verify=True)
    assert b.kind == "sparse" and b.step == 7 and b.dtype == "float32"
    assert set(b.tables) == {f"{f}_embed" for f in SIZE_MAP}


def test_dlrm_dedup_stack_bundle_is_the_reference_bundle(tmp_path):
    from tdfo_tpu.models.dlrm import DLRMBackbone as JDLRM
    from tdfo_tpu.models.dlrm import generic_embedding_specs as jspecs
    from tdfo_tpu.parallel.embedding import ShardedEmbeddingCollection as JColl
    from tdfo_tpu_torch.interop import backbone_params_from_flax, tables_from_numpy
    from tdfo_tpu_torch.models.dlrm import DLRMBackbone as TDLRM
    from tdfo_tpu_torch.models.dlrm import generic_embedding_specs as tspecs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection as TColl

    sizes = {"c0": 500, "c1": 90, "c2": 12, "c3": 700}
    cats, conts = tuple(sizes), ("x0", "x1")
    jc = JColl(jspecs(sizes, cats, 8, "row", fused_threshold=400),
               fused_kind="rowwise_adagrad", stack_tables=True)
    tc = TColl(tspecs(sizes, cats, 8, "row", fused_threshold=400),
               fused_kind="rowwise_adagrad", stack_tables=True)
    # the port's init carried into the reference (same array names)
    tt = tc.init(1, device="cpu")
    jt = {k: jnp.asarray(v.numpy()) for k, v in tt.items()}
    assert sorted(jt) == sorted(jax.eval_shape(jc.init, jax.random.key(0)))
    assert {k.split("_8_")[0] for k in jt} >= {"__fatstack", "__tablestack"}
    jb = JDLRM(embed_dim=8, cat_columns=cats, cont_columns=conts)
    jd = jax.jit(jb.init)(jax.random.key(2), {c: jnp.zeros((1, 8)) for c in cats},
                          {c: jnp.zeros((1,)) for c in conts})["params"]
    tb = TDLRM(8, cat_columns=cats, cont_columns=conts)
    tb.load_state_dict(backbone_params_from_flax(jax.tree.map(np.asarray, jd)))
    _both(tmp_path, dict(coll=jc, tables=jt, dense_params=jd),
          dict(coll=tc, tables=tt, dense_params=tb),
          dict(model="dlrm", embed_dim=8, cat_columns=cats, cont_columns=conts,
               size_map=sizes))


def test_int8_hot_cold_unflushed_cache_bundle(tmp_path):
    """int8 plain stacks + hot heads + an update cache holding dirty rows
    after two steps: the port's export of the UNFLUSHED state (the cache
    overlaid) equals the reference's export of the flushed state and the
    port's own, bit for bit."""
    from tdfo_tpu.models.dlrm import generic_embedding_specs as jspecs
    from tdfo_tpu.parallel.embedding import ShardedEmbeddingCollection as JColl
    from tdfo_tpu_torch.models.dlrm import DLRMBackbone as TDLRM
    from tdfo_tpu_torch.models.dlrm import generic_embedding_specs as tspecs
    from tdfo_tpu_torch.ops.sparse import sparse_optimizer as topt
    from tdfo_tpu_torch.parallel.embedding import CACHE_PREFIX
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection as TColl
    from tdfo_tpu_torch.train.ctr import ctr_sparse_forward
    from tdfo_tpu_torch.train.sparse_step import SparseTrainState as TState
    from tdfo_tpu_torch.train.sparse_step import make_cache_flush_fn, make_sparse_train_step

    sizes = {"c0": 400, "c1": 90, "c2": 12, "c3": 300}
    cats, conts = tuple(sizes), ("x0",)
    hot = {"c0": np.arange(32, dtype=np.int32),
           "c1": np.array([1, 4, 5, 17, 40], np.int32)}
    kw = dict(hot_ids=hot, stack_tables=True, fused_kind="adam", cache_rows=2048)
    tspec = [dataclasses.replace(s, dtype=torch.int8)
             for s in tspecs(sizes, cats, 8, "row", fused_threshold=None)]
    tc = TColl(tspec, **kw)
    tb = TDLRM(8, cat_columns=cats, cont_columns=conts,
               generator=torch.Generator().manual_seed(2))
    opt = topt("adam", lr=3e-3, small_vocab_threshold=0)
    ts = TState.create(backbone=tb, tables=tc.init(0, device="cpu"), sparse_opt=opt,
                       learning_rate=3e-3, weight_decay=0.0)
    ts.slots.update(tc.init_caches(ts.tables, opt))
    step = make_sparse_train_step(tc, ctr_sparse_forward(tb), dedup_lookup=True)
    rng = np.random.default_rng(0)
    for _ in range(2):
        batch = {c: rng.integers(0, v, 64).astype(np.int32) for c, v in sizes.items()}
        batch.update(x0=rng.random(64).astype(np.float32),
                     label=rng.integers(0, 2, 64).astype(np.float32))
        ts, _ = step(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    caches = {k: v for k, v in ts.slots.items() if k.startswith(CACHE_PREFIX)}
    assert caches and any(bool(c["dirty"].any()) for c in caches.values())
    assert any("qs" in c for c in caches.values())
    common = dict(model="dlrm", embed_dim=8, cat_columns=cats,
                  cont_columns=conts, size_map=sizes)
    ta = texp.export_bundle(tmp_path / "torch", coll=tc, tables=ts.tables,
                            dense_params=tb, caches=caches, **common)
    ts, over = make_cache_flush_fn()(ts)
    assert {int(v) for v in over.values()} == {0}
    tf = texp.export_bundle(tmp_path / "torch_flushed", coll=tc, tables=ts.tables,
                            dense_params=tb, **common)
    jc = JColl([dataclasses.replace(s, dtype=jnp.int8)
                for s in jspecs(sizes, cats, 8, "row", fused_threshold=None)], **kw)
    ja = jexp.export_bundle(
        tmp_path / "jax_flushed", coll=jc,
        tables={k: jnp.asarray(v.numpy()) for k, v in ts.tables.items()},
        dense_params=jax.tree.map(jnp.asarray, flax_params_from_module(tb)), **common)
    assert_same_bundle(ta, tf)
    assert_same_bundle(ja, ta)


def test_dense_twotower_bundle_is_the_reference_bundle(tmp_path):
    from tdfo_tpu.models.twotower import TwoTower as JTwoTower
    from tdfo_tpu_torch.interop import dense_params_from_flax
    from tdfo_tpu_torch.models.twotower import TwoTower as TTwoTower

    sizes = {k: max(4, v // 4) for k, v in SIZE_MAP.items()}
    jm = JTwoTower(size_map=sizes, embed_dim=8)
    rng = np.random.default_rng(0)
    batch = {c: jnp.asarray(rng.integers(0, 2, 4).astype(np.int32)) for c in CAT_COLS}
    batch.update({c: jnp.zeros((4,), jnp.float32) for c in CONT_COLS})
    params = jax.jit(jm.init)(jax.random.key(0), batch)["params"]
    tm = TTwoTower(sizes, 8)
    tm.load_state_dict(dense_params_from_flax(jax.tree.map(np.asarray, params)))
    common = dict(model="twotower", embed_dim=8, cat_columns=CAT_COLS,
                  cont_columns=CONT_COLS, size_map=sizes, step=3)
    ja, _ = _both(tmp_path, dict(params=params), dict(params=tm), common)
    b = texp.load_bundle(ja)
    assert b.kind == "dense" and b.tables is None
    assert b.params["user_embed"]["embedding"].shape == (sizes["user"], 8)


@pytest.mark.parametrize("platforms,dtype", [(("tpu", "tpu"), "bfloat16"),
                                             (("gpu", "cuda"), "float16")])
def test_cast_policies_match_the_reference(tmp_path, platforms, dtype):
    """``mixed_precision``: bf16 ships uint16 bit patterns (round to nearest
    even); the GPU's f16 policy ships f32 arrays under a "float16"
    manifest; both as the reference writes them."""
    jc, _, jt, jd = jax_twotower(seed=1)
    tc, tt, tb = port_twotower(jt, jd)
    ja = jexp.export_bundle(tmp_path / "j", coll=jc, tables=jt, dense_params=jd,
                            mixed_precision=True, platform=platforms[0],
                            **twotower_export_kw())
    ta = texp.export_bundle(tmp_path / "t", coll=tc, tables=tt, dense_params=tb,
                            mixed_precision=True, platform=platforms[1],
                            **twotower_export_kw())
    assert_same_bundle(ja, ta)
    b = texp.load_bundle(ta)
    assert b.dtype == dtype
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert {t.dtype for t in b.tables.values()} == {want}
    assert b.torch_dtype == want


def test_merged_tables_match_the_lookup_and_the_reference():
    """The exported rows are what the lookup serves (fat stack, plain
    stack, hot heads merged back over poisoned cold rows)."""
    from tdfo_tpu_torch.models.dlrm import generic_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    sizes = {"big": 900, "small": 60, "mid": 70}
    hot = {"mid": np.array([0, 3, 50], np.int32)}
    coll = ShardedEmbeddingCollection(
        generic_embedding_specs(sizes, tuple(sizes), 16, "row", fused_threshold=500),
        stack_tables=True, hot_ids=hot)
    tables = coll.init(2, device="cpu")
    aname, _, off = coll.resolve_table("mid_embed")
    tables[aname][off + hot["mid"]] = 7777.0  # dead cold duplicates
    merged = texp.merged_tables(coll, tables)
    for col, size in sizes.items():
        assert merged[f"{col}_embed"].shape == (size, 16)
        ids = np.random.default_rng(1).integers(0, size, 64).astype(np.int32)
        looked = coll.lookup(tables, {col: torch.from_numpy(ids)})
        np.testing.assert_array_equal(merged[f"{col}_embed"][ids], looked[col].numpy())
    assert not np.any(merged["mid_embed"] == 7777.0)


def test_bundle_refusals(tmp_path):
    jc, _, jt, jd = jax_twotower()
    tc, tt, tb = port_twotower(jt, jd)
    out = texp.export_bundle(tmp_path / "b", coll=tc, tables=tt, dense_params=tb,
                             **twotower_export_kw())
    with pytest.raises(ValueError, match="not a serving bundle"):
        texp.load_bundle(tmp_path / "nope")
    manifest = json.loads((out / "bundle.json").read_text())
    for bad, msg in [(dict(manifest, bundle_version=2), "bundle_version"),
                     (dict(manifest, tables=dict(manifest["tables"], ghost=[4, 16])),
                      "torn bundle"),
                     (dict(manifest, tables=dict(manifest["tables"], item_embed=[3, 3])),
                      "torn bundle"),
                     (dict(manifest, kind="ann"), "unknown kind")]:
        (out / "bundle.json").write_text(json.dumps(bad))
        with pytest.raises(ValueError, match=msg):
            texp.load_bundle(out)
    (out / "bundle.json").write_text(json.dumps(dict(manifest, step=99)))
    texp.load_bundle(out)  # loads; only verify checks the content digest
    with pytest.raises(ValueError, match="content digest"):
        texp.load_bundle(out, verify=True)
    with pytest.raises(ValueError, match="not both"):
        texp.export_bundle(tmp_path / "x", **twotower_export_kw())


def test_fused_int8_export_refuses_as_the_reference_fails(tmp_path):
    """Byte-container fat lines: the reference's merged_tables reads them
    through the f32 geometry and fails; the port refuses by name."""
    from tdfo_tpu.models.twotower import ctr_embedding_specs as jspecs
    from tdfo_tpu.parallel.embedding import ShardedEmbeddingCollection as JColl
    from tdfo_tpu_torch.models.twotower import ctr_embedding_specs as tspecs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection as TColl

    tc = TColl([dataclasses.replace(s, dtype=torch.int8)
                for s in tspecs(SIZE_MAP, DIM, "row", fused_threshold=200)])
    tt = tc.init(0, device="cpu")
    assert any(t.dim() == 3 and t.dtype == torch.int8 for t in tt.values())
    jc = JColl([dataclasses.replace(s, dtype=jnp.int8)
                for s in jspecs(SIZE_MAP, DIM, "row", fused_threshold=200)])
    with pytest.raises(TypeError):
        jexp.merged_tables(jc, {k: v.numpy() for k, v in tt.items()})
    with pytest.raises(ValueError, match="fused int8 tables"):
        texp.merged_tables(tc, tt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_corpus_store_is_the_reference_store(tmp_path, dtype):
    from tdfo_tpu.serve.corpus import Corpus as JCorpus
    from tdfo_tpu.ops.quant import quantize_rows as jq
    from tdfo_tpu_torch.serve.corpus import Corpus, store_corpus

    rng = np.random.default_rng(3)
    v = rng.standard_normal((50, 8)).astype(np.float32)
    ids = np.arange(50, dtype=np.int32)
    tcorp = store_corpus(torch.from_numpy(v), torch.from_numpy(ids), 50, dtype)
    jv, jqs = jnp.asarray(v), None
    if dtype == "bfloat16":
        jv = jv.astype(jnp.bfloat16)
    elif dtype == "int8":
        jv, jqs = jq(jv)
    jexp.export_corpus(tmp_path / "j", JCorpus(jv, jnp.asarray(ids), 50, jqs), step=4)
    texp.export_corpus(tmp_path / "t", tcorp, step=4)
    for f in ("corpus.json",):
        assert (tmp_path / "j" / f).read_text() == (tmp_path / "t" / f).read_text()
    back = texp.load_corpus(tmp_path / "j", device="cpu")
    assert isinstance(back, Corpus) and back.n_items == 50
    assert torch.equal(back.vectors, tcorp.vectors)
    if dtype == "int8":
        assert torch.equal(back.qscale, tcorp.qscale)
        # a legitimately stamped store from a build with another grid
        m = dict(json.loads((tmp_path / "t" / "corpus.json").read_text()),
                 qscale_layout="other")
        with np.load(tmp_path / "t" / "corpus.npz") as z:
            m["digest"] = texp.bundle_digest(m, {k: z[k] for k in z.files})
        (tmp_path / "t" / "corpus.json").write_text(json.dumps(m))
        with pytest.raises(ValueError, match="qscale_layout"):
            texp.load_corpus(tmp_path / "t", device="cpu")
    # a data-2 mesh's shards: 25 rows each, together the corpus
    shards = [texp.load_corpus(tmp_path / "j", mesh=StubMesh(2, r), device="cpu")
              for r in range(2)]
    assert [(c.shard, c.n_shards, c.rows_per_shard, c.n_items) for c in shards] == [
        (0, 2, 25, 50), (1, 2, 25, 50)]
    assert torch.equal(torch.cat([c.vectors for c in shards]), back.vectors)
    assert torch.equal(torch.cat([c.ids for c in shards]), back.ids)
