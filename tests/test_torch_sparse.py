"""Row-sparse tiers of the PyTorch port against ``tdfo_tpu/ops/sparse.py``:
dedupe (exact), the lazy dense adam tier, row-sparse adam and the other
plain kinds, and ``SparseOptimizer``'s tier dispatch.  Optimizer math is
held to rtol 1e-6 / atol 1e-7; ids and untouched rows exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdfo_tpu.ops import sparse as jsp
from tdfo_tpu_torch.interop import TOL
from tdfo_tpu_torch.ops import fat_lines as tfl
from tdfo_tpu_torch.ops import sparse as tsp
from tdfo_tpu_torch.ops.kernels import fat_line_update as tk

RTOL, ATOL = TOL["optimizer"]


def _ids(rng, v, b):
    ids = rng.integers(0, v, b).astype(np.int32)
    ids[::5] = -1
    ids[1:b - 1:9] = ids[2::9][: len(ids[1:b - 1:9])]  # duplicates
    return ids


@pytest.mark.parametrize("r", [1, 2, 8])
def test_dedupe_ids_exact(r):
    rng = np.random.default_rng(r)
    ids = _ids(rng, 500, 300)
    ju, js, jv = jax.jit(functools.partial(jsp.dedupe_ids, rows_per_line=r))(
        jnp.asarray(ids))
    tu, ts, tv = tsp.dedupe_ids(torch.from_numpy(ids), rows_per_line=r)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # capacity licensed by the vocab bound, and the refusal without one
    ju, _, _ = jax.jit(functools.partial(jsp.dedupe_ids, capacity=64, vocab=60))(
        jnp.asarray(ids))
    tu, _, _ = tsp.dedupe_ids(torch.from_numpy(ids), capacity=64, vocab=60)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    with pytest.raises(ValueError, match="capacity"):
        tsp.dedupe_ids(torch.from_numpy(ids), capacity=64)


def test_dedupe_grads():
    rng = np.random.default_rng(4)
    ids = _ids(rng, 50, 200)
    g = rng.standard_normal((200, 8)).astype(np.float32)
    ju, jg, jv = jax.jit(jsp.dedupe_grads)(jnp.asarray(ids), jnp.asarray(g))
    tu, tg, tv = tsp.dedupe_grads(torch.from_numpy(ids), torch.from_numpy(g))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-6)


def _check_rows(got, want, before, touched):
    np.testing.assert_array_equal(got[~touched], before[~touched])
    np.testing.assert_array_equal(got[~touched], want[~touched])
    np.testing.assert_allclose(got[touched], want[touched], rtol=RTOL, atol=ATOL)


def test_dense_lazy_adam_matches_jax():
    rng = np.random.default_rng(2)
    v, d, b = 40, 8, 64
    table = rng.standard_normal((v, d)).astype(np.float32)
    mu = rng.standard_normal((v, d)).astype(np.float32)
    nu = rng.random((v, d)).astype(np.float32)
    ids = _ids(rng, v - 10, b)  # rows >= v-10 stay untouched
    ids[3] = v + 4  # out of range: contributes nothing in both packages
    g = rng.standard_normal((b, d)).astype(np.float32)
    kw = dict(lr=0.05, weight_decay=1e-2)
    jt, jm, jn, jc = jax.jit(functools.partial(jsp.dense_lazy_adam, **kw))(
        jnp.asarray(table), jnp.asarray(mu), jnp.asarray(nu),
        jnp.asarray(4, jnp.int32), jnp.asarray(ids), jnp.asarray(g))
    tt, tm, tn, tc = tsp.dense_lazy_adam(
        torch.from_numpy(table.copy()), torch.from_numpy(mu.copy()),
        torch.from_numpy(nu.copy()), torch.tensor(4, dtype=torch.int32),
        torch.from_numpy(ids), torch.from_numpy(g), **kw)
    touched = np.isin(np.arange(v), ids[(ids >= 0) & (ids < v)])
    for got, want, before in ((tt, jt, table), (tm, jm, mu), (tn, jn, nu)):
        _check_rows(got.numpy(), np.asarray(want), before, touched)
    assert int(tc) == int(jc) == 5


@pytest.mark.parametrize("kind", ["adam", "sgd", "adagrad", "rowwise_adagrad"])
def test_plain_row_tier_matches_jax(kind):
    """Large plain tables (above the small-vocab threshold): dedupe +
    ``sparse_<kind>``, through ``SparseOptimizer.update``."""
    rng = np.random.default_rng(8)
    v, d, b = 90, 16, 120
    table = rng.standard_normal((v, d)).astype(np.float32)
    ids = _ids(rng, v, b)
    g = rng.standard_normal((b, d)).astype(np.float32)
    jopt = jsp.SparseOptimizer(kind=kind, lr=0.05, weight_decay=1e-2,
                               small_vocab_threshold=16)
    topt = tsp.SparseOptimizer(kind=kind, lr=0.05, weight_decay=1e-2,
                               small_vocab_threshold=16)
    jt, js = jax.jit(jopt.update)(jnp.asarray(table),
                                  jopt.init(jnp.asarray(table)),
                                  jnp.asarray(ids), jnp.asarray(g))
    tt0 = torch.from_numpy(table.copy())
    tt, ts = topt.update(tt0, topt.init(tt0), torch.from_numpy(ids),
                         torch.from_numpy(g))
    touched = np.isin(np.arange(v), ids[ids >= 0])
    _check_rows(tt.numpy(), np.asarray(jt), table, touched)
    for a, b_ in zip(ts, js):
        a, b_ = a.numpy(), np.asarray(b_)
        if a.ndim == 0:
            assert int(a) == int(b_)
        else:
            np.testing.assert_allclose(a, b_, rtol=RTOL, atol=ATOL)


def test_tier_dispatch():
    """fat lines -> ``fat_update`` through the ``fat_line_update`` wrapper;
    small plain adam -> the lazy dense tier (each tier is held against the
    JAX package above and in ``test_torch_fat_lines.py``)."""
    rng = np.random.default_rng(6)
    d, b = 16, 64
    opt = tsp.SparseOptimizer(kind="adam", lr=0.05, weight_decay=1e-2)
    ids = torch.from_numpy(_ids(rng, 100, b))
    g = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    small = torch.from_numpy(rng.standard_normal((100, d)).astype(np.float32))
    fat = tfl.fat_pack(small, kind="adam")
    before = tk.fat_line_update.plain_runs
    got, slots = opt.update(small.clone(), opt.init(small), ids, g)
    want = tsp.dense_lazy_adam(small.clone(), *opt.init(small), ids, g,
                               lr=0.05, weight_decay=1e-2)
    assert len(slots) == 3 and torch.equal(got, want[0])
    assert tk.fat_line_update.plain_runs == before
    got, slots = opt.update(fat.clone(), opt.init(fat), ids, g, embedding_dim=d)
    want, _ = tsp.fat_update(fat.clone(), (torch.tensor(0, dtype=torch.int32),),
                             ids, g, embedding_dim=d, kind="adam", lr=0.05,
                             weight_decay=1e-2)
    assert len(slots) == 1 and int(slots[0]) == 1 and torch.equal(got, want)
    assert tk.fat_line_update.plain_runs == before + 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsp.SparseOptimizer(kind="adam", lr=0.1, slot_dtype="bfloat16")


@pytest.mark.parametrize("fused", [True, False])
def test_lookup_out_of_range_ids_match_jax(fused):
    """In-range, negative and past-the-end ids read what the JAX package
    reads: jnp.take's default mode="fill" wraps negatives of a plain table
    and gives NaN rows past it; the fat path reads row 0 for negatives and
    NaN for a line past the table."""
    from tdfo_tpu.parallel import embedding as jemb
    from tdfo_tpu_torch.interop import tables_from_numpy
    from tdfo_tpu_torch.parallel import embedding as temb

    v, d = 203, 16
    kw = dict(num_embeddings=v, embedding_dim=d, features=("f",),
              fused=fused)
    jcoll = jemb.ShardedEmbeddingCollection([jemb.EmbeddingSpec("t", **kw)])
    tcoll = temb.ShardedEmbeddingCollection([temb.EmbeddingSpec("t", **kw)])
    jt = jcoll.init(jax.random.key(0))
    tt = tables_from_numpy({k: np.asarray(x) for k, x in jt.items()})
    assert (tt["t"].dim() == 3) == fused
    ids = np.array([[0, 5, v - 1, -1, -3, -v], [-v - 1, v, v + 7, 4096, 1, 2]],
                   np.int32)
    want = np.asarray(jcoll.lookup(jt, {"f": jnp.asarray(ids)})["f"])
    got = tcoll.lookup(tt, {"f": torch.from_numpy(ids)})["f"].numpy()
    assert got.shape == (2, 6, d)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[1, 2:4]).all() and np.isfinite(got[0, :3]).all()
