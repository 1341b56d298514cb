"""``fat_line_update``: the fused fat-line optimizer step, hand-written CUDA
for Hopper (``ops/csrc/fat_line_update.cu``) plus its plain PyTorch version.

Port of ``tdfo_tpu/ops/pallas_kernels.py::fat_line_update`` (the Pallas TPU
kernel) and of its portable formulation
``tdfo_tpu/ops/sparse.py::_fat_apply_lines_xla``.

* :func:`fat_line_update` is the wrapper every caller uses.  For a CUDA
  ``fat`` it checks the operands and launches the kernel on PyTorch's
  current stream, or raises; there is no fallback.  For a CPU ``fat`` it
  runs :func:`fat_line_update_plain`.  Its ``launches`` attribute counts
  kernel launches only; ``plain_runs`` counts the plain-version runs on the
  CPU.
* :func:`fat_line_update_plain` is the torch transcription of
  ``_fat_apply_lines_xla``: gather the slot rows through ``fat_view``, apply
  the kind's math, keep touched slots only, ``index_copy_`` them back.  The
  CPU path and the kernel's oracle.

Both update ``fat`` IN PLACE (the reference donated the buffer) and return
it: clone first to keep the old table.  ``ulines`` must be duplicate-free
(``ops.sparse.dedupe_ids`` guarantees it).  The bf16 stochastic-rounding
writeback of the TPU kernel is not ported (``ROADMAP.md`` Queue A item 13):
both functions refuse a non-f32 table.
"""

from __future__ import annotations

import ctypes

import torch

from tdfo_tpu_torch.ops.fat_lines import LANE, LineLayout, fat_view

__all__ = ["fat_line_update", "fat_line_update_plain", "KIND_CODES"]

SENTINEL = 2**31 - 1  # int32 max: padding slots of a dedupe
KIND_CODES = {"sgd": 0, "adagrad": 1, "rowwise_adagrad": 2, "adam": 3}


def _check(fat, ulines, g, touched, corr, layout: LineLayout) -> bool:
    """Validate operands; returns True for the row form."""
    if fat.dtype != torch.float32:
        raise NotImplementedError(
            f"fat_line_update: {fat.dtype} fat lines need the bf16/SR "
            "writeback, which is not ported yet (ROADMAP.md Queue A item 13)")
    if fat.dim() != 3 or fat.shape[1] != layout.tiles or fat.shape[2] != LANE:
        raise ValueError(
            f"fat must be [L, {layout.tiles}, {LANE}], got {tuple(fat.shape)}")
    if ulines.dim() != 1 or ulines.dtype != torch.int32:
        raise ValueError(f"ulines must be 1-D int32, got {ulines.dtype} "
                         f"{tuple(ulines.shape)}")
    u = ulines.shape[0]
    row_form = g.dim() == 2
    if row_form:
        if layout.r != 1 or touched is not None:
            raise ValueError("row-form grads [U, d] need R == 1 and no mask")
        if tuple(g.shape) != (u, layout.d):
            raise ValueError(f"g must be [{u}, {layout.d}], got {tuple(g.shape)}")
    else:
        if tuple(g.shape) != (u, layout.r, layout.d):
            raise ValueError(f"packed g must be [{u}, {layout.r}, {layout.d}], "
                             f"got {tuple(g.shape)}")
        if touched is None or tuple(touched.shape) != (u, layout.r):
            raise ValueError(f"packed form needs touched [{u}, {layout.r}]")
        if touched.dtype != torch.float32:
            raise ValueError(f"touched must be f32, got {touched.dtype}")
    if g.dtype != torch.float32:
        raise ValueError(f"g must be f32, got {g.dtype}")
    if tuple(corr.shape) != (2,) or corr.dtype != torch.float32:
        raise ValueError("corr must be f32 [2]")
    return row_form


def fat_line_update_plain(fat, ulines, g, touched, corr, *, layout: LineLayout,
                          lr: float, b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8, weight_decay: float = 0.0):
    """Plain PyTorch version (same operands and contract as
    :func:`fat_line_update`).  Updates ``fat`` in place and returns it."""
    row_form = _check(fat, ulines, g, touched, corr, layout)
    d, r, kind, wd = layout.d, layout.r, layout.kind, weight_decay
    n_lines = fat.shape[0]
    view = fat_view(fat, layout)
    lines = ulines.to(torch.int64)
    ok = (lines >= 0) & (lines < n_lines)
    base = torch.where(ok, lines, torch.zeros_like(lines))
    idx = (base[:, None] * r + torch.arange(r, device=fat.device)).reshape(-1)
    rows_full = view[idx]
    table = rows_full[:, :d]
    g = g.reshape(-1, d)
    if kind == "sgd":
        g2 = g + wd * table
        parts = {0: table - lr * g2}
    elif kind == "rowwise_adagrad":
        acc = rows_full[:, d]
        g2 = g + wd * table
        acc_n = acc + torch.mean(g2 * g2, dim=-1)
        delta = lr * g2 / (torch.sqrt(acc_n)[:, None] + eps)
        parts = {0: table - delta, d: acc_n[:, None]}
    elif kind == "adagrad":
        acc = rows_full[:, d:2 * d]
        g2 = g + wd * table
        acc_n = acc + g2 * g2
        delta = lr * g2 / (torch.sqrt(acc_n) + eps)
        parts = {0: table - delta, d: acc_n}
    else:  # adam
        mu, nu = rows_full[:, d:2 * d], rows_full[:, 2 * d:3 * d]
        mu_n = b1 * mu + (1 - b1) * g
        nu_n = b2 * nu + (1 - b2) * g * g
        mu_hat = mu_n / corr[0]
        nu_hat = nu_n / corr[1]
        delta = lr * (mu_hat / (torch.sqrt(nu_hat) + eps) + wd * table)
        parts = {0: table - delta, d: mu_n, 2 * d: nu_n}
    new_rows = rows_full.clone()
    for off, comp in parts.items():
        new_rows[:, off:off + comp.shape[1]] = comp
    keep = ok.repeat_interleave(r)
    if not row_form:
        keep = keep & (touched.reshape(-1) > 0)
    view.index_copy_(0, idx[keep], new_rows[keep])
    return fat


def _launch(fat, ulines, g, touched, corr, *, layout, lr, b1, b2, eps,
            weight_decay):
    from tdfo_tpu_torch.ops.kernels.build import load

    dev = fat.device
    for name, t in (("ulines", ulines), ("g", g), ("corr", corr),
                    ("touched", touched)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"fat_line_update: {name} on {t.device}, fat on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"fat_line_update: {name} must be contiguous")
    if not fat.is_contiguous():
        raise ValueError("fat_line_update: fat must be contiguous")
    lib = load("fat_line_update")
    fn = lib.fat_line_update_f32
    if fn.argtypes is None:
        vp, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_float)
        fn.argtypes = [vp, vp, vp, vp, vp, i64, i64, i32, i32, i32, i32,
                       f32, f32, f32, f32, f32, f32, f32, vp]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(fat.data_ptr(), ulines.data_ptr(), g.data_ptr(),
                 None if touched is None else touched.data_ptr(),
                 corr.data_ptr(), fat.shape[0], ulines.shape[0], layout.r,
                 layout.w, layout.d, KIND_CODES[layout.kind], lr, b1, b2,
                 1 - b1, 1 - b2, eps, weight_decay, stream)
    if err != 0:
        raise RuntimeError(f"fat_line_update kernel launch failed: CUDA error {err}")


def fat_line_update(fat, ulines, g, touched, corr, *, layout: LineLayout,
                    lr: float, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8, weight_decay: float = 0.0):
    """In-place fused optimizer step on the touched lines of a fat table.

    ``fat [L, T, 128]`` f32; ``ulines [U]`` int32 duplicate-free line ids
    (int32 max = padding); ``g`` row form ``[U, d]`` (R == 1,
    ``touched=None``) or packed ``[U, R, d]`` with ``touched [U, R]`` f32;
    ``corr [2]`` f32 adam bias corrections (unused by the other kinds).
    CUDA tensors launch the kernel; CPU tensors run the plain version.
    Returns ``fat``."""
    kw = dict(layout=layout, lr=lr, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
    if fat.device.type == "cpu":
        fat_line_update.plain_runs += 1
        return fat_line_update_plain(fat, ulines, g, touched, corr, **kw)
    if fat.device.type != "cuda":
        raise ValueError(f"fat_line_update: unsupported device {fat.device}")
    _check(fat, ulines, g, touched, corr, layout)
    _launch(fat, ulines, g, touched, corr, **kw)
    fat_line_update.launches += 1
    return fat


fat_line_update.launches = 0
fat_line_update.plain_runs = 0
