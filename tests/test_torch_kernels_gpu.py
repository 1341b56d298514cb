"""Card-only checks of the port's hand-written kernels (``gpu`` marker).

Each kernel against its plain PyTorch version on the card, at small sizes:
the fat-line kernels for every optimizer kind and operand form (the routed
one also bitwise against ``fat_line_update``), the flash kernels in f32 and
bf16.  They skip without a CUDA card (a CUDA kernel has no CPU mode).
This file imports neither jax nor the JAX package, so it also runs on a
machine without them:
``python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest``
(the repository's ``conftest.py`` imports jax).  ``chip_smoke.py`` runs the
full-width version of these checks.
"""

import numpy as np
import pytest
import torch

from tdfo_tpu_torch.interop import TOL
from tdfo_tpu_torch.ops import fat_lines as tfl
from tdfo_tpu_torch.ops import sparse as tsp
from tdfo_tpu_torch.ops.kernels import fat_line_update as tk

KINDS = ("sgd", "adagrad", "rowwise_adagrad", "adam")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [16, 64])
def test_fat_line_update_matches_plain_on_card(kind, d):
    """Every kind, row form (R == 1) and packed form (R > 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(9)
    lay = tfl.line_layout(d, kind)
    v, b = 4000, 512
    fat = tfl.fat_pack(torch.randn(v, d), kind=kind).cuda()
    ids = torch.from_numpy(rng.integers(-1, v, b)).cuda()
    ul, seg, _ = tsp.dedupe_ids(ids, vocab=v, rows_per_line=lay.r)
    c = ul.shape[0]
    g = tsp._segment_sum(torch.randn(b, d, device="cuda"), seg, c * lay.r)
    corr = torch.tensor([0.1, 0.001], device="cuda")
    if lay.r == 1:
        g, tl = g.view(c, d), None
    else:
        g = g.view(c, lay.r, d)
        tl = (tsp._segment_sum((ids >= 0).float(), seg, c * lay.r) > 0
              ).float().view(c, lay.r)
    a, k = fat.clone(), fat.clone()
    tk.fat_line_update_plain(a, ul, g, tl, corr, layout=lay, lr=0.05,
                             weight_decay=1e-2)
    tk.fat_line_update(k, ul, g, tl, corr, layout=lay, lr=0.05,
                       weight_decay=1e-2)
    torch.cuda.synchronize()
    rtol, atol = TOL["optimizer"]
    torch.testing.assert_close(k, a, rtol=rtol, atol=atol)
    launches = tk.fat_line_update.launches
    tk.fat_line_update(k, ul, g, tl, corr, layout=lay, lr=0.05)
    assert tk.fat_line_update.launches == launches + 1


SENTINEL = 2**31 - 1
GROUP_DS = (4, 8, 12, 20, 32, 48, 64, 100, 128, 200)


def _slot_operands(kind, d, n_lines, u, *, dtype=torch.float32, packed=False,
                   seed=0):
    """A fat table of ``n_lines`` lines with random content in every lane
    (pad lanes too, so a stray write shows; state lanes >= 0), ``u``
    distinct lines with the sentinel, a negative and an out-of-range line
    among them (where ``u`` has room), and grads in the row form or, with
    ``packed``, the packed form with a partial touched mask."""
    rng = np.random.default_rng(seed)
    lay = tfl.line_layout(d, kind, "bfloat16" if dtype == torch.bfloat16 else "float32")
    fat = torch.from_numpy(rng.random((n_lines, lay.tiles, 128), dtype=np.float32))
    view = fat.view(-1, lay.w)
    view[:, :d] -= 0.5
    if kind == "adam":
        view[:, d:2 * d] -= 0.5
    ul = rng.permutation(n_lines)[:u].astype(np.int32)
    for i, bad in zip((1, 2, 3), (SENTINEL, -5, n_lines + 3)):
        if i < u:
            ul[i] = bad
    if packed or lay.r > 1:
        g = rng.standard_normal((u, lay.r, d)).astype(np.float32)
        tl = (rng.random((u, lay.r)) > 0.3).astype(np.float32)
        tl = torch.from_numpy(tl).cuda()
    else:
        g, tl = rng.standard_normal((u, d)).astype(np.float32), None
    return (lay, fat.to(dtype).cuda(), torch.from_numpy(ul).cuda(),
            torch.from_numpy(g).cuda(), tl)


def _updatable(fat, ul, tl, lay):
    """[L*R, W] bool: lanes [0, need) of every slot the step may write."""
    n = fat.shape[0]
    lines = ul.to(torch.int64)
    ok = (lines >= 0) & (lines < n)
    slots = (torch.where(ok, lines, 0)[:, None] * lay.r
             + torch.arange(lay.r, device=fat.device)).reshape(-1)
    keep = ok.repeat_interleave(lay.r)
    if tl is not None:
        keep &= tl.reshape(-1) > 0
    m = torch.zeros((n * lay.r, lay.w), dtype=torch.bool, device=fat.device)
    m[slots[keep], :lay.need] = True
    return m


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", GROUP_DS)
def test_fat_line_update_row_groups_on_card(kind, d):
    """The redesigned kernel's edges: every kind at d below, at and past
    each row-group width (G = 2 .. 32 threads per row; d % 4 != 0 never
    occurs in a layout, d = 200 takes a warp per row), in the row form and
    the packed form (R == 1 layouts both); U = 0, 1, 3, ragged against the
    slots per warp and per block, and large enough for several passes of
    the resident grid; sentinel, negative and out-of-range lines and a
    partial touched mask.  Kernel vs plain within the optimizer tolerance,
    every element it may not write bitwise unchanged, and the grads one
    element off 16 bytes (a warp per row, chosen inside the launch) give
    bitwise the same table, rowwise_adagrad's sum tree included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    lay = tfl.line_layout(d, kind)
    forms = (False, True) if lay.r == 1 else (True,)
    corr = torch.tensor([0.1, 0.001], device="cuda")
    kw = dict(layout=lay, lr=0.05, weight_decay=1e-2)
    rtol, atol = TOL["optimizer"]
    for packed in forms:
        for u, n_lines in ((0, 16), (1, 16), (3, 16), (37, 64), (1005, 3000),
                           (100_003, 100_010)):
            lay, fat, ul, g, tl = _slot_operands(kind, d, n_lines, u,
                                                 packed=packed, seed=u + d)
            a, k, w = fat.clone(), fat.clone(), fat.clone()
            tk.fat_line_update_plain(a, ul, g, tl, corr, **kw)
            launches = tk.fat_line_update.launches
            tk.fat_line_update(k, ul, g, tl, corr, **kw)
            # (an empty tensor has no data pointer to offset)
            tk.fat_line_update(w, ul, _offset_copy(g) if u else g, tl, corr, **kw)
            torch.cuda.synchronize()
            assert tk.fat_line_update.launches == launches + 2
            name = f"{kind} d={d} U={u} packed={packed}"
            torch.testing.assert_close(k, a, rtol=rtol, atol=atol, msg=lambda m: f"{name}: {m}")
            m = _updatable(fat, ul, tl, lay)
            kv, fv = k.view(-1, lay.w), fat.view(-1, lay.w)
            assert torch.equal(kv[~m].view(torch.int32), fv[~m].view(torch.int32)), name
            assert torch.equal(k.view(torch.int32), w.view(torch.int32)), name


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [8, 20, 64, 128, 200])
def test_fat_line_update_bf16_row_groups_on_card(kind, d):
    """bf16 lines through the row groups (and a warp per row at d = 200):
    with a seed at the TPU grid's 8 and 128 lines per block, and without a
    seed (round to nearest), bitwise the plain version wherever the f32
    kernel is bitwise its plain version (``_check_bf16``); the unaligned
    grads' warp path writes bitwise the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    corr = torch.tensor([0.1, 0.001], device="cuda")
    lay = tfl.line_layout(d, kind, "bfloat16")
    for packed in ((False, True) if lay.r == 1 else (True,)):
        lay, fat, ul, g, tl = _slot_operands(kind, d, 3000, 1005, dtype=torch.bfloat16,
                                             packed=packed, seed=d)
        for seed, lps in ((1234567, 8), (1234567, 128), (None, 128)):
            kw = dict(layout=lay, lr=0.05, weight_decay=1e-2, sr_seed=seed,
                      lines_per_step=lps)
            out = {}
            for dt in (torch.bfloat16, torch.float32):
                a, k = fat.to(dt, copy=True), fat.to(dt, copy=True)
                tk.fat_line_update_plain(a, ul, g, tl, corr, **kw)
                tk.fat_line_update(k, ul, g, tl, corr, **kw)
                out[dt] = (k, a)
            w = fat.clone()
            tk.fat_line_update(w, ul, _offset_copy(g), tl, corr, **kw)
            torch.cuda.synchronize()
            name = f"bf16 {kind} d={d} packed={packed} seed={seed} lps={lps}"
            _check_bf16(name, kind, *out[torch.bfloat16], *out[torch.float32], fat)
            assert torch.equal(w.view(torch.int16), out[torch.bfloat16][0].view(torch.int16)), name


@pytest.mark.gpu
def test_fat_line_update_refuses_mixed_devices():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    lay = tfl.line_layout(64, "adam")
    fat = torch.zeros((4, lay.tiles, 128), device="cuda")
    ul = torch.tensor([0, 1], dtype=torch.int32)  # on the CPU
    with pytest.raises(ValueError, match="ulines"):
        tk.fat_line_update(fat, ul, torch.zeros(2, 64, device="cuda"), None,
                           torch.ones(2, device="cuda"), layout=lay, lr=0.1)


# ------------------------------------------------------ fat_line_update_routed


def _routed_operands(kind, d, v=4000, b=512, seed=10):
    """A fat table on the card, one step's routing (negative ids, shared
    lines, capacity padding), the forward's line gather and row grads."""
    from tdfo_tpu_torch.parallel.embedding import take_fill

    rng = np.random.default_rng(seed)
    lay = tfl.line_layout(d, kind)
    fat = tfl.fat_pack(torch.randn(v, d), kind=kind).cuda()
    view = fat.view(-1, lay.w)
    view[:, d:lay.need] = view[:, d:lay.need].abs() + 0.1  # accumulators >= 0
    ids = torch.from_numpy(rng.integers(-1, v, b)).cuda()
    seg, ul, rl, rs = tsp.dedupe_rows_and_lines(
        ids, capacity_rows=b + 8, capacity_lines=b, rows_per_line=lay.r)
    lines = take_fill(fat, torch.where(ul < 2**31 - 1, ul, 0))
    g_u = torch.randn(b + 8, d, device="cuda")
    return lay, fat, lines, ul, rl, rs, g_u


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_fat_line_update_routed_matches_plain_on_card(kind, d):
    """Kernel vs plain version within the optimizer tolerance, and bitwise
    equal to ``fat_line_update`` fed the same update in slot space."""
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as tkr

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    lay, fat, lines, ul, rl, rs, g_u = _routed_operands(kind, d)
    corr = torch.tensor([0.1, 0.001], device="cuda")
    kw = dict(layout=lay, lr=0.05, weight_decay=1e-2)
    a, k, f = fat.clone(), fat.clone(), fat.clone()
    tkr.fat_line_update_routed_plain(a, lines, ul, rl, rs, g_u, corr, **kw)
    launches = tkr.fat_line_update_routed.launches
    tkr.fat_line_update_routed(k, lines, ul, rl, rs, g_u, corr, **kw)
    torch.cuda.synchronize()
    assert tkr.fat_line_update_routed.launches == launches + 1
    rtol, atol = TOL["optimizer"]
    torch.testing.assert_close(k, a, rtol=rtol, atol=atol)
    g_slots, touched = tkr.routed_to_slots(ul, rl, rs, g_u, lay)
    tk.fat_line_update(f, ul, g_slots, touched, corr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k.view(torch.int32), f.view(torch.int32))


def _full_line_operands(kind, d, n_lines, pad_rows, seed=11):
    """Routing where every touched line holds R touched rows (all slots of
    ``n_lines`` lines, shuffled) plus ``pad_rows`` capacity padding rows, so
    the row count is a multiple of neither the rows per warp nor the
    resident grid's rows per pass."""
    from tdfo_tpu_torch.parallel.embedding import take_fill

    rng = np.random.default_rng(seed)
    lay = tfl.line_layout(d, kind)
    v = (n_lines + 7) * lay.r
    fat = tfl.fat_pack(torch.randn(v, d), kind=kind).cuda()
    view = fat.view(-1, lay.w)
    view[:, d:lay.need] = view[:, d:lay.need].abs() + 0.1
    ids = torch.from_numpy(rng.permutation(n_lines * lay.r)).cuda()
    b = ids.shape[0]
    seg, ul, rl, rs = tsp.dedupe_rows_and_lines(
        ids, capacity_rows=b + pad_rows, capacity_lines=b, rows_per_line=lay.r)
    lines = take_fill(fat, torch.where(ul < 2**31 - 1, ul, 0))
    g_u = torch.randn(b + pad_rows, d, device="cuda")
    return lay, fat, lines, ul, rl, rs, g_u


@pytest.mark.gpu
@pytest.mark.parametrize("kind,d,n_lines", [
    ("rowwise_adagrad", 16, 50_001), ("rowwise_adagrad", 8, 3_001),
    ("adam", 32, 77_777), ("sgd", 64, 1_001), ("adagrad", 16, 20_003)])
def test_fat_line_update_routed_full_lines_ragged_rows_on_card(kind, d, n_lines):
    """Every touched line holds R touched rows; row counts ragged against
    the kernel's rows per warp and its resident grid (several passes)."""
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as tkr

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    lay, fat, lines, ul, rl, rs, g_u = _full_line_operands(kind, d, n_lines, 5)
    corr = torch.tensor([0.1, 0.001], device="cuda")
    kw = dict(layout=lay, lr=0.05, weight_decay=1e-2)
    a, k, f = fat.clone(), fat.clone(), fat.clone()
    tkr.fat_line_update_routed_plain(a, lines, ul, rl, rs, g_u, corr, **kw)
    tkr.fat_line_update_routed(k, lines, ul, rl, rs, g_u, corr, **kw)
    torch.cuda.synchronize()
    rtol, atol = TOL["optimizer"]
    torch.testing.assert_close(k, a, rtol=rtol, atol=atol)
    g_slots, touched = tkr.routed_to_slots(ul, rl, rs, g_u, lay)
    assert int(touched.sum()) == n_lines * lay.r
    tk.fat_line_update(f, ul, g_slots, touched, corr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k.view(torch.int32), f.view(torch.int32))


def _offset_copy(x):
    """A contiguous copy of ``x`` whose data starts one element past a
    16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("kind,d", [("rowwise_adagrad", 16), ("adam", 32),
                                    ("sgd", 8)])
def test_fat_line_update_routed_unaligned_operands_on_card(kind, d):
    """``fat``, ``lines`` and ``g_u`` one element off 16 bytes (the narrow
    rows' 16-byte loads cannot serve them; a warp per row does): the same
    result as the plain version and as ``fat_line_update``."""
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as tkr

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    lay, fat, lines, ul, rl, rs, g_u = _routed_operands(kind, d, seed=12)
    corr = torch.tensor([0.1, 0.001], device="cuda")
    kw = dict(layout=lay, lr=0.05, weight_decay=1e-2)
    a, f = fat.clone(), fat.clone()
    k = _offset_copy(fat)
    tkr.fat_line_update_routed_plain(a, lines, ul, rl, rs, g_u, corr, **kw)
    tkr.fat_line_update_routed(k, _offset_copy(lines), ul, rl, rs,
                               _offset_copy(g_u), corr, **kw)
    torch.cuda.synchronize()
    rtol, atol = TOL["optimizer"]
    torch.testing.assert_close(k, a, rtol=rtol, atol=atol)
    g_slots, touched = tkr.routed_to_slots(ul, rl, rs, g_u, lay)
    tk.fat_line_update(f, ul, g_slots, touched, corr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k.view(torch.int32), f.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_fat_line_update_routed_rowwise_wide_bitwise_on_card(d, dtype):
    """rowwise_adagrad at d = 32 (8 threads a row in both kernels), 64 and
    128 (the routed kernel's warp per row, warp_sum's tree; 16 and 32
    threads a row in ``fat_line_update``): the two kernels write bitwise
    the same table (bf16 at the routed grid's lines per block)."""
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as tkr

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    lay32, fat32, _, ul, rl, rs, g_u = _routed_operands("rowwise_adagrad", d, seed=23)
    lay = tfl.line_layout(d, "rowwise_adagrad",
                          "bfloat16" if dtype == torch.bfloat16 else "float32")
    fat = fat32.to(dtype)
    lines = fat[torch.where(ul < 2**31 - 1, ul, 0).long()].contiguous()
    corr = torch.zeros(2, device="cuda")
    seed = 77 if dtype == torch.bfloat16 else None
    kw = dict(layout=lay, lr=0.05, weight_decay=1e-2, sr_seed=seed)
    k, f = fat.clone(), fat.clone()
    tkr.fat_line_update_routed(k, lines, ul, rl, rs, g_u, corr, **kw)
    g_slots, touched = tkr.routed_to_slots(ul, rl, rs, g_u, lay)
    tk.fat_line_update(f, ul, g_slots, touched, corr,
                       lines_per_step=tkr.routed_lines_per_step(lay), **kw)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert not torch.equal(k.view(bits), fat.view(bits))
    assert torch.equal(k.view(bits), f.view(bits))


@pytest.mark.gpu
def test_fat_line_update_routed_refuses_mixed_devices():
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as tkr

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    lay, fat, lines, ul, rl, rs, g_u = _routed_operands("rowwise_adagrad", 16)
    with pytest.raises(ValueError, match="row_lidx"):
        tkr.fat_line_update_routed(fat, lines, ul, rl.cpu(), rs, g_u,
                                   torch.ones(2, device="cuda"), layout=lay, lr=0.1)


# ---------------------------------------------------- bf16 fat lines (SR)


def _ulps(a, b):
    """Distance in bf16 steps between two bf16 tensors (bit patterns)."""
    def order(t):
        x = t.view(torch.int16).to(torch.int64) & 0xFFFF
        return torch.where(x >= 0x8000, -(x & 0x7FFF), x)
    return (order(a) - order(b)).abs()


def _check_bf16(name, kind, k16, p16, k32, p32, base):
    """bf16 kernel ``k16`` vs plain ``p16`` on the same operands and seed:
    bitwise equal wherever the f32 kernel ``k32`` is bitwise its plain
    version ``p32`` on the same (widened) operands, one bf16 ulp apart
    elsewhere; every element the step left alone is bitwise ``base``.
    Returns the count of one-ulp elements."""
    ulps = _ulps(k16, p16)
    same32 = k32.view(torch.int32) == p32.view(torch.int32)
    assert int(ulps.max()) <= 1, name
    assert not bool((ulps[same32] > 0).any()), (name, kind)
    # untouched: the plain version left the element alone in bf16 and in f32
    moved = ((p16.view(torch.int16) != base.view(torch.int16))
             | (p32.view(torch.int32) != base.float().view(torch.int32)))
    assert torch.equal(k16.view(torch.int16)[~moved], base.view(torch.int16)[~moved]), name
    return int((ulps > 0).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [16, 64])
def test_fat_line_update_bf16_matches_plain_on_card(kind, d):
    """bf16 lines, stochastic rounding: every kind, row and packed form,
    more than one 128-line grid block; another seed changes the bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(19)
    lay = tfl.line_layout(d, kind, "bfloat16")
    v, b = 4000, 512
    fat = tfl.fat_pack(torch.randn(v, d), kind=kind, dtype=torch.bfloat16).cuda()
    view = fat.view(-1, lay.w)
    view[:, d:lay.need] = view[:, d:lay.need].abs() + 0.1
    ids = torch.from_numpy(rng.integers(-1, v, b)).cuda()
    ul, seg, _ = tsp.dedupe_ids(ids, vocab=v, rows_per_line=lay.r)
    c = ul.shape[0]
    g = tsp._segment_sum(torch.randn(b, d, device="cuda"), seg, c * lay.r)
    corr = torch.tensor([0.1, 0.001], device="cuda")
    if lay.r == 1:
        g, tl = g.view(c, d), None
    else:
        g = g.view(c, lay.r, d)
        tl = (tsp._segment_sum((ids >= 0).float(), seg, c * lay.r) > 0
              ).float().view(c, lay.r)
    kw = dict(layout=lay, lr=0.05, weight_decay=1e-2)
    out = {}
    for dt, seed in ((torch.bfloat16, 1234567), (torch.float32, None)):
        a, k = fat.to(dt, copy=True), fat.to(dt, copy=True)
        tk.fat_line_update_plain(a, ul, g, tl, corr, sr_seed=seed, **kw)
        tk.fat_line_update(k, ul, g, tl, corr, sr_seed=seed, **kw)
        torch.cuda.synchronize()
        out[dt] = (k, a)
    _check_bf16(f"{kind} d={d}", kind, *out[torch.bfloat16], *out[torch.float32], fat)
    other = fat.clone()
    tk.fat_line_update(other, ul, g, tl, corr, sr_seed=7654321, **kw)
    torch.cuda.synchronize()
    assert not torch.equal(other.view(torch.int16),
                           out[torch.bfloat16][0].view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [8, 16, 32, 64])
@pytest.mark.parametrize("offset", [False, True])
def test_fat_line_update_routed_bf16_matches_plain_on_card(kind, d, offset):
    """bf16 routed kernel (aligned: narrow row groups where d <= 32;
    ``offset``: operands one element off 16 bytes, a warp per row) vs its
    plain version, and bitwise ``fat_line_update`` given the routed grid's
    lines per block."""
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as tkr

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    lay32, fat32, _, ul, rl, rs, g_u = _routed_operands(kind, d, seed=20)
    lay = tfl.line_layout(d, kind, "bfloat16")
    fat = fat32.to(torch.bfloat16)
    corr = torch.tensor([0.1, 0.001], device="cuda")
    kw = dict(layout=lay, lr=0.05, weight_decay=1e-2)
    out = {}
    for dt, seed in ((torch.bfloat16, 99), (torch.float32, None)):
        base = fat.to(dt)
        lines = base[torch.where(ul < 2**31 - 1, ul, 0).long()].contiguous()
        a = base.clone()
        k = _offset_copy(base) if offset else base.clone()
        tkr.fat_line_update_routed_plain(a, lines, ul, rl, rs, g_u, corr,
                                         sr_seed=seed, **kw)
        launches = tkr.fat_line_update_routed.launches
        tkr.fat_line_update_routed(k, _offset_copy(lines) if offset else lines,
                                   ul, rl, rs, _offset_copy(g_u) if offset else g_u,
                                   corr, sr_seed=seed, **kw)
        torch.cuda.synchronize()
        assert tkr.fat_line_update_routed.launches == launches + 1
        out[dt] = (k, a)
    _check_bf16(f"routed {kind} d={d}", kind, *out[torch.bfloat16],
                *out[torch.float32], fat)
    g_slots, touched = tkr.routed_to_slots(ul, rl, rs, g_u, lay)
    f = fat.clone()
    tk.fat_line_update(f, ul, g_slots, touched, corr, sr_seed=99,
                       lines_per_step=tkr.routed_lines_per_step(lay), **kw)
    torch.cuda.synchronize()
    assert torch.equal(out[torch.bfloat16][0].view(torch.int16), f.view(torch.int16))


@pytest.mark.gpu
def test_bf16_kernels_round_to_nearest_without_a_seed():
    """No seed: both bf16 kernels round to nearest, bitwise the plain
    versions (``.to(torch.bfloat16)``) where the f32 math agrees."""
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as tkr

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    _, fat32, _, ul, rl, rs, g_u = _routed_operands("sgd", 16, seed=21)
    lay = tfl.line_layout(16, "sgd", "bfloat16")
    fat = fat32.to(torch.bfloat16)
    lines = fat[torch.where(ul < 2**31 - 1, ul, 0).long()].contiguous()
    corr = torch.zeros(2, device="cuda")
    a, k = fat.clone(), fat.clone()
    tkr.fat_line_update_routed_plain(a, lines, ul, rl, rs, g_u, corr, layout=lay, lr=0.05)
    tkr.fat_line_update_routed(k, lines, ul, rl, rs, g_u, corr, layout=lay, lr=0.05)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), k.view(torch.int16))


# ------------------------------------------------------------ flash attention


def _flash_inputs(dtype, b=2, h=2, t=45, dh=32, seed=0):
    """Random q, k, v, dO on the card; key padding, one fully masked row,
    and (t = 45) a ragged last tile of 13 rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, h, t, dh), generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    kv = torch.rand((b, t), generator=gen, device="cuda") > 0.25
    kv[-1] = False  # every key of the last batch row masked
    return q, k, v, do, kv


def _flash_tol(dtype, ref):
    """f32: 2e-5 (summation order only).  bf16: the kernel and its plain
    version round p / ds / the output to bf16 at the same places, so they
    differ by about one bf16 ulp (2^-8 relative) of the largest term."""
    if dtype == torch.float32:
        return dict(rtol=2e-5, atol=2e-5)
    return dict(rtol=2e-2, atol=2e-2 * float(ref.float().abs().max()) + 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,dh", [(45, 32), (20, 64), (100, 8)])
def test_flash_kernels_match_plain_on_card(dtype, t, dh):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v, do, kv = _flash_inputs(dtype, t=t, dh=dh)
    out, lse = fa.flash_fwd(q, k, v, kv)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, kv)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), out_p.float(), **_flash_tol(dtype, out_p))
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)
    assert torch.isinf(lse[-1]).all() and (out[-1] == 0).all()  # masked row
    inf_out, none = fa.flash_fwd(q, k, v, kv, with_lse=False)
    assert none is None and torch.equal(inf_out, out)
    delta = (do.float() * out_p.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, kv, lse_p, delta)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, kv, lse_p, delta)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, kv, lse_p, delta)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, kv, lse_p, delta)
    torch.cuda.synchronize()
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
               else _flash_tol(dtype, want))
        torch.testing.assert_close(got.float(), want.float(), **tol)
    assert (dq[-1] == 0).all() and (dk[-1] == 0).all() and (dv[-1] == 0).all()


def _edge_inputs(dtype, t, dh):
    """B = H = 3 (9 heads, not a multiple of any heads-per-block packing), a
    masked first key tile in batch row 0 and a fully masked last batch row."""
    q, k, v, do, kv = _flash_inputs(dtype, b=3, h=3, t=t, dh=dh, seed=t + dh)
    kv[:, -1] = True
    kv[0, :min(40, t // 2)] = False  # a whole first key tile at T >= 80
    kv[-1] = False                   # every key of the last batch row masked
    return q, k, v, do, kv


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [8, 32, 64, 128])
@pytest.mark.parametrize("t", [1, 15, 16, 17, 20, 24, 25, 31, 33, 63, 64, 65, 127, 128,
                               257])
def test_flash_fwd_dq_tile_edges_on_card(dtype, dh, t):
    """The forward (with and without lse) and dQ against their plain
    versions at the edges of their tilings: T below, at and past the 16-,
    24-, 32- and 64-row tiles and the 128 rows where the bf16 kernels
    switch from four warps to eight."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v, do, kv = _edge_inputs(dtype, t, dh)
    launches = fa.flash_fwd.launches, fa.flash_bwd_dq.launches
    out, lse = fa.flash_fwd(q, k, v, kv)
    inf_out, none = fa.flash_fwd(q, k, v, kv, with_lse=False)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, kv)
    delta = (do.float() * out_p.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, kv, lse_p, delta)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, kv, lse_p, delta)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches) == (
        launches[0] + 2, launches[1] + 1)
    torch.testing.assert_close(out.float(), out_p.float(), **_flash_tol(dtype, out_p))
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)
    assert none is None and torch.equal(inf_out, out)
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
           else _flash_tol(dtype, dq_p))
    torch.testing.assert_close(dq.float(), dq_p.float(), **tol)
    assert torch.isinf(lse[-1]).all() and (out[-1] == 0).all() and (dq[-1] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_dq_unaligned_operands_on_card(dtype):
    """q, k, v and dO one element off 16 bytes: the wrappers copy them for
    the kernels' 16-byte accesses, and the results are the plain versions'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v, do, kv = _flash_inputs(dtype, b=3, h=2, t=20, dh=32, seed=6)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, kv)
    delta = (do.float() * out_p.float()).sum(-1)
    qo, ko, vo, doo = (_offset_copy(x) for x in (q, k, v, do))
    out, lse = fa.flash_fwd(qo, ko, vo, kv)
    dq = fa.flash_bwd_dq(qo, ko, vo, doo, kv, lse_p, delta)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, kv, lse_p, delta)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), out_p.float(), **_flash_tol(dtype, out_p))
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
           else _flash_tol(dtype, dq_p))
    torch.testing.assert_close(dq.float(), dq_p.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [8, 32, 64, 128])
@pytest.mark.parametrize("t", [1, 20, 31, 33, 100, 257])
def test_flash_bwd_dkv_tile_edges_on_card(dtype, dh, t):
    """dK/dV against its plain version at the tile geometry's edges: T
    below, at and past the key tiles (1, 31, 33, 257), B*H = 9 heads (not a
    multiple of the heads per block), a masked first key tile in batch row 0
    and a fully masked batch row (zero gradients)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v, do, kv = _edge_inputs(dtype, t, dh)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, kv)
    delta = (do.float() * out_p.float()).sum(-1)
    launches = fa.flash_bwd_dkv.launches
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, kv, lse_p, delta)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, kv, lse_p, delta)
    torch.cuda.synchronize()
    assert fa.flash_bwd_dkv.launches == launches + 1
    for got, want in ((dk, dk_p), (dv, dv_p)):
        tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
               else _flash_tol(dtype, want))
        torch.testing.assert_close(got.float(), want.float(), **tol)
    assert (dk[-1] == 0).all() and (dv[-1] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_dkv_unaligned_operands_on_card(dtype):
    """q, k, v and dO one element off 16 bytes: the wrapper copies them for
    the kernel's 16-byte accesses, and the result is the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v, do, kv = _flash_inputs(dtype, b=3, h=2, t=20, dh=32, seed=5)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, kv)
    delta = (do.float() * out_p.float()).sum(-1)
    dk, dv = fa.flash_bwd_dkv(*(_offset_copy(x) for x in (q, k, v, do)), kv,
                              lse_p, delta)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, kv, lse_p, delta)
    torch.cuda.synchronize()
    for got, want in ((dk, dk_p), (dv, dv_p)):
        tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
               else _flash_tol(dtype, want))
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
def test_flash_autograd_counts_launches_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v, do, kv = _flash_inputs(torch.float32)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    (fa.flash_attention(q, k, v, kv) * do).sum().backward()
    torch.cuda.synchronize()
    after = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
             fa.flash_bwd_dkv.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


@pytest.mark.gpu
def test_flash_refuses_bad_operands_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    q = torch.zeros((1, 1, 8, 130), device="cuda")
    kv = torch.ones((1, 8), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="Dh"):
        fa.flash_fwd(q, q, q, kv)
    q = torch.zeros((1, 1, 8, 32), device="cuda")
    with pytest.raises(ValueError, match="key_valid"):
        fa.flash_fwd(q, q, q, kv.cpu())
    with pytest.raises(ValueError, match="k is"):
        fa.flash_fwd(q, q.to(torch.bfloat16), q, kv)
