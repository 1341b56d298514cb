"""Retrieval and corpus builds of the PyTorch port against ``tdfo_tpu``'s,
on the CPU, by the rule of ``torch_serve_helpers.assert_retrieval_matches``:
scores at rtol 1e-5, ids exactly at every separated rank.  Ties (equal
stored vectors, padding rows) are held exactly: lower id first, padding
never returned.  The reference's own bitwise pins (its jitted and eager
int8 decodes differ by an ulp) are not copied.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_serve_helpers import (
    SIZE_MAP,
    StubMesh,
    jax_twotower,
    np_of,
    port_twotower,
    twotower_export_kw,
    assert_retrieval_matches,
)

from tdfo_tpu.ops.quant import quantize_rows as j_quantize
from tdfo_tpu.serve import corpus as jcorp
from tdfo_tpu.serve import retrieval as jret
from tdfo_tpu_torch.serve import corpus as tcorp
from tdfo_tpu_torch.serve import retrieval as tret


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(v: np.ndarray, dtype: str, ids=None):
    """The same stored corpus in both packages (int8: each package's
    quantizer on the same f32 rows; the codes must agree)."""
    n = v.shape[0]
    ids = np.arange(n, dtype=np.int32) if ids is None else ids
    n_items = int((ids >= 0).sum())
    t = tcorp.store_corpus(torch.from_numpy(v), torch.from_numpy(ids), n_items, dtype)
    jv, jq = jnp.asarray(v), None
    if dtype == "bfloat16":
        jv = jv.astype(jnp.bfloat16)
    elif dtype == "int8":
        jv, jq = j_quantize(jv)
        assert np.array_equal(np.asarray(jv), t.vectors.numpy())
        assert np.array_equal(np.asarray(jq), t.qscale.numpy())
    return jcorp.Corpus(vectors=jv, ids=jnp.asarray(ids), n_items=n_items, qscale=jq), t


def _rand(n, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def test_mips_scores_formula():
    q, v = _rand(5, seed=1), _rand(40, seed=2)
    got = tret.mips_scores(torch.from_numpy(q), torch.from_numpy(v))
    want = np.asarray(jret.mips_scores(jnp.asarray(q), jnp.asarray(v)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_exact_retrieval_matches_the_reference(dtype):
    jc, tc = _pair(_rand(700), dtype)
    q = _rand(12, seed=3)
    got = tret.make_retrieval(tc, top_k=20)(torch.from_numpy(q))
    want = jret.make_retrieval(jc, top_k=20)(jnp.asarray(q))
    full = jret.retrieval_reference(jnp.asarray(q), jc, top_k=21)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert_retrieval_matches(got, want, full[0])
    assert_retrieval_matches(got, (full[0][:, :20], full[1][:, :20]), full[0])
    # the port's own reference (a stable full sort) agrees exactly
    ref = tret.retrieval_reference(torch.from_numpy(q), tc, top_k=20)
    assert torch.equal(got[1], ref[1].to(torch.int32))
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype,coarse_k", [("int8", 200), ("float32", 150)])
def test_two_stage_retrieval_matches_the_reference(dtype, coarse_k):
    jc, tc = _pair(_rand(900, seed=4), dtype)
    q = _rand(10, seed=5)
    got = tret.make_retrieval(tc, top_k=20, coarse_k=coarse_k)(torch.from_numpy(q))
    want = jret.make_retrieval(jc, top_k=20, coarse_k=coarse_k)(jnp.asarray(q))
    full = jret.retrieval_reference(jnp.asarray(q), jc, top_k=21)
    assert_retrieval_matches(got, want, full[0])
    # the re-rank is exact: its scores are the exact scan's
    exact = tret.make_retrieval(tc, top_k=20)(torch.from_numpy(q))
    hit = got[1] == exact[1]
    np.testing.assert_allclose(got[0][hit].numpy(), exact[0][hit].numpy(),
                               rtol=1e-6, atol=1e-7)
    assert hit.float().mean() > 0.9


def test_ragged_corpus_clamps_and_degenerate_routes_to_exact():
    jc, tc = _pair(_rand(130, seed=6), "int8")
    q = _rand(6, seed=7)
    exact = tret.make_retrieval(tc, top_k=100)(torch.from_numpy(q))
    for coarse_k in (120, 130, 500):  # 130, 500: nothing can be dropped
        r = tret.make_retrieval(tc, top_k=100, coarse_k=coarse_k)
        assert r.coarse_k == (coarse_k if coarse_k < 130 else 0)
        got = r(torch.from_numpy(q))
        want = jret.make_retrieval(jc, top_k=100, coarse_k=coarse_k)(jnp.asarray(q))
        full = jret.retrieval_reference(jnp.asarray(q), jc, top_k=101)
        assert_retrieval_matches(got, want, full[0])
        if coarse_k >= 130:
            assert torch.equal(got[1], exact[1]) and torch.equal(got[0], exact[0])


@pytest.mark.parametrize("coarse_k", [0, 8])
def test_ties_go_to_the_lower_id_and_padding_is_never_returned(coarse_k):
    """Integer-valued rows and queries (every score exact): rows 2, 5, 9
    and 11 are one vector, padding rows (id -1) hold a larger one."""
    rng = np.random.default_rng(8)
    v = rng.integers(-3, 4, (16, 4)).astype(np.float32)
    v[[5, 9, 11]] = v[2]
    v[[3, 14]] = 50.0  # padding rows scoring highest
    ids = np.arange(16, dtype=np.int32)
    ids[[3, 14]] = -1
    q = np.abs(rng.integers(1, 3, (3, 4))).astype(np.float32)
    jc, tc = _pair(v, "float32", ids=ids)
    got = tret.make_retrieval(tc, top_k=6, coarse_k=coarse_k)(torch.from_numpy(q))
    want = jret.make_retrieval(jc, top_k=6, coarse_k=coarse_k)(jnp.asarray(q))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert (got[1] >= 0).all()
    # the reference's stable argsort orders the real rows the same way
    s = q @ v[ids >= 0].T
    order = np.argsort(-s, axis=1, kind="stable")[:, :6]
    np.testing.assert_array_equal(got[1].numpy(), ids[ids >= 0][order])
    # an explicit tie block: equal values keep position order
    vals, pos = tret.top_k_ordered(torch.tensor([[1.0, 2.0, 2.0, -0.0, 0.0, 2.0]]), 5)
    assert pos.tolist() == [[1, 2, 5, 0, 3]]


def test_retrieval_validation():
    _, tc = _pair(_rand(50), "float32")
    for kw, msg in [(dict(top_k=0), ">= 1"), (dict(top_k=51), "exceeds"),
                    (dict(top_k=5, coarse_k=-1), ">= 0"),
                    (dict(top_k=5, coarse_k=3), "must be >= top_k")]:
        with pytest.raises(ValueError, match=msg):
            tret.make_retrieval(tc, **kw)
    # a corpus built for one device does not retrieve over a data-2 mesh
    with pytest.raises(ValueError, match="sharded 1 ways"):
        tret.make_retrieval(tc, mesh=StubMesh(2))


def test_corpus_build_matches_the_reference(tmp_path):
    """The item-tower sweep (a ragged last chunk) over the same bundle in
    both packages: vectors at the logits rung; int8 corpora decode within
    a grid step of each other; retrieval over the two corpora agrees."""
    from tdfo_tpu.serve.export import export_bundle as j_export
    from tdfo_tpu.serve.export import load_bundle as j_load
    from tdfo_tpu.serve.scoring import make_scorer as j_scorer
    from tdfo_tpu_torch.serve.export import load_bundle as t_load
    from tdfo_tpu_torch.serve.scoring import make_scorer as t_scorer

    jc, _, jt, jd = jax_twotower(seed=2)
    bdir = j_export(tmp_path / "b", coll=jc, tables=jt, dense_params=jd,
                    **twotower_export_kw())
    n = SIZE_MAP["item"]
    feats = tcorp.synthetic_item_features(SIZE_MAP, n, seed=3)
    jfeats = jcorp.synthetic_item_features(SIZE_MAP, n, seed=3)
    assert all(np.array_equal(feats[k], jfeats[k]) for k in jfeats)
    tsc, jsc = t_scorer(t_load(bdir), device="cpu"), j_scorer(j_load(bdir))
    tc = tcorp.build_corpus(tsc, feats, corpus_batch=96)
    jcc = jcorp.build_corpus(jsc, jfeats, corpus_batch=96)
    assert tc.n_items == n and tuple(tc.vectors.shape) == (n, 16)
    np.testing.assert_array_equal(tc.ids.numpy(), np.asarray(jcc.ids))
    np.testing.assert_allclose(tc.vectors.numpy(), np.asarray(jcc.vectors),
                               rtol=1e-5, atol=1e-6)
    t8 = tcorp.build_corpus(tsc, feats, corpus_batch=96, dtype="int8")
    j8 = jcorp.build_corpus(jsc, jfeats, corpus_batch=96, dtype="int8")
    from tdfo_tpu_torch.ops.quant import dequantize_rows

    tv = dequantize_rows(t8.vectors, t8.qscale).numpy()
    jv = dequantize_rows(np.asarray(j8.vectors), np.asarray(j8.qscale))
    step = np.asarray(j8.qscale)[:, :1]
    assert np.all(np.abs(tv - jv) <= 1.01 * step + 1e-6)
    assert (t8.vectors.numpy() == np.asarray(j8.vectors)).mean() > 0.99
    q = np_of(tsc.user_embed({"user_id": np.arange(8, dtype=np.int32)}))
    got = tret.make_retrieval(tc, top_k=10)(torch.from_numpy(q))
    want = jret.make_retrieval(jcc, top_k=10)(jnp.asarray(q))
    full = jret.retrieval_reference(jnp.asarray(q), jcc, top_k=11)
    assert_retrieval_matches(got, want, full[0])
