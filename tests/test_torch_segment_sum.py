"""The port's deterministic segment sum (``ops/kernels/segment_sum.py``).

On the CPU the wrapper runs ``index_add_``; the kernel adds each segment's
members left to right from 0.0 in input order.  These tests hold an exact
emulation of that order (the kernel's plan, then one serial f32 add per
member, rounded once to the dtype) bitwise to ``index_add_`` on zipf-skewed
ids with negative and out-of-range ids dropped, in f32 and bf16, so the
card's sums equal the CPU's.  ``dedupe_grads`` and the dense lazy tier's
per-row sums stay the JAX package's.  The card test holds the kernel to
its plain version bitwise (``gpu`` marker).
"""

import numpy as np
import pytest
import torch

from tdfo_tpu_torch.ops import sparse as tsp
from tdfo_tpu_torch.ops.kernels.segment_sum import (
    segment_plan,
    segment_sum,
    segment_sum_plain,
)


def _zipf_ids(rng, n, vocab):
    """Duplicate-heavy ids with padding (-1) and out-of-range ids mixed in."""
    ids = (rng.zipf(1.3, n) - 1) % vocab
    ids[rng.random(n) < 0.05] = -1
    ids[rng.random(n) < 0.03] = vocab + 7
    return ids.astype(np.int64)


def _kernel_order(x, seg, n, plan=None):
    """What the CUDA kernel computes, in torch ops: for every segment, its
    members in the plan's order, added serially from 0.0 in f32, then
    rounded once to ``x``'s dtype."""
    order, offsets = segment_plan(seg, n, plan)
    xs = x.reshape(x.shape[0], -1)[order]
    lo, hi = offsets[:-1], offsets[1:]
    length = hi - lo
    acc = torch.zeros((n, xs.shape[1]), dtype=torch.float32)
    for k in range(int(length.max()) if n else 0):
        live = length > k
        acc[live] = acc[live] + xs[lo[live] + k].float()
    return acc.to(x.dtype).reshape(n, *x.shape[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 16), (3000,)])
def test_input_order_sum_is_index_add_bitwise(dtype, shape):
    rng = np.random.default_rng(3)
    n = 500
    seg = torch.from_numpy(_zipf_ids(rng, shape[0], n))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    want = segment_sum_plain(x, seg, n)
    ok = (seg >= 0) & (seg < n)
    x2 = x.reshape(shape[0], -1)
    ref = torch.zeros((n, x2.shape[1]), dtype=dtype).index_add_(0, seg[ok], x2[ok])
    assert torch.equal(want.reshape(n, -1).float().view(torch.int32),
                       ref.float().view(torch.int32))
    got = _kernel_order(x, seg, n)
    assert got.dtype == dtype
    assert torch.equal(got.float().view(torch.int32), want.float().view(torch.int32))


def test_wrapper_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(5)
    seg = torch.from_numpy(_zipf_ids(rng, 1000, 64))
    x = torch.from_numpy(rng.standard_normal((1000, 8)).astype(np.float32))
    runs, launches = segment_sum.plain_runs, segment_sum.launches
    out = segment_sum(x, seg, 64)
    assert segment_sum.plain_runs == runs + 1 and segment_sum.launches == launches
    assert torch.equal(out, segment_sum_plain(x, seg, 64))


def test_dedupe_plan_is_the_sort_the_kernel_needs():
    """The dedupe's stable sort serves as the segment plan: the kernel's
    order over it equals ``index_add_`` by the dedupe's segments."""
    rng = np.random.default_rng(8)
    ids = torch.from_numpy(_zipf_ids(rng, 4096, 3000))
    g = torch.from_numpy(rng.standard_normal((4096, 16)).astype(np.float32))
    for r in (1, 4):
        uids, seg, valid, plan = tsp.dedupe_ids(ids, rows_per_line=r,
                                                with_plan=True)
        n = uids.shape[0] * r
        got = _kernel_order(g, seg, n, plan)
        assert torch.equal(got, segment_sum_plain(g, seg, n))
    seg, ul, rl, rs, plan = tsp.dedupe_rows_and_lines(
        ids, capacity_rows=4096, capacity_lines=4096, rows_per_line=4,
        with_plan=True)
    assert torch.equal(_kernel_order(g, seg, 4096, plan),
                       segment_sum_plain(g, seg, 4096))


def test_dedupe_grads_and_lazy_tier_match_jax():
    import jax
    import jax.numpy as jnp

    from tdfo_tpu.ops import sparse as jsp

    rng = np.random.default_rng(11)
    v, b, d = 300, 2048, 8
    ids = _zipf_ids(rng, b, v).astype(np.int32)
    ids[ids > v] = -1  # the reference's dedupe takes no id past the vocab
    g = rng.standard_normal((b, d)).astype(np.float32)
    ju, jg, jv = jax.jit(jsp.dedupe_grads)(jnp.asarray(ids), jnp.asarray(g))
    tu, tg, tv = tsp.dedupe_grads(torch.from_numpy(ids), torch.from_numpy(g))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
    table = np.zeros((v, d), np.float32)
    jgs, jt = jax.jit(jsp._one_hot_gsum)(jnp.asarray(table), jnp.asarray(ids),
                                          jnp.asarray(g))
    tgs, tt = tsp._dense_gsum(torch.from_numpy(table), torch.from_numpy(ids),
                              torch.from_numpy(g))
    np.testing.assert_array_equal(tt.numpy().reshape(-1),
                                  np.asarray(jt).reshape(-1) > 0)
    np.testing.assert_allclose(tgs.numpy(), np.asarray(jgs), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_kernel_matches_plain_bitwise_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(1)
    seg = torch.from_numpy(_zipf_ids(rng, 8192, 2000))
    x = torch.from_numpy(rng.standard_normal((8192, 64)).astype(np.float32)).to(dtype)
    want = segment_sum_plain(x, seg, 2000)
    launches = segment_sum.launches
    got = segment_sum(x.cuda(), seg.cuda(), 2000)
    assert segment_sum.launches == launches + 1
    assert torch.equal(got.cpu(), want)
