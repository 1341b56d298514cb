"""``fat_line_update_routed``: the fused fat-line optimizer step of the
dedup-lookup path, hand-written CUDA for Hopper
(``ops/csrc/fat_line_update_routed.cu``) plus its plain PyTorch version.

Port of ``tdfo_tpu/ops/pallas_kernels.py::fat_line_update_routed`` (the
Pallas TPU kernel) and of its portable formulation, the XLA fallback of
``tdfo_tpu/ops/sparse.py::fat_apply_routed``.

The step takes ROW-level summed grads ``g_u [CR, d]`` in sorted-unique order
and the routing of ``ops.sparse.dedupe_rows_and_lines`` (``ulines [C]``,
``row_lidx [CR]``, ``row_slot [CR]``), plus ``lines [C, T, 128]``, the
forward's gather of ``fat`` at ``ulines``.  Distinct row ``i`` updates slot
``row_slot[i]`` of line ``ulines[row_lidx[i]]``; padding rows (``row_lidx
>= C``), the sentinel line and lines outside ``[0, L)`` are skipped.

* :func:`fat_line_update_routed` is the wrapper every caller uses.  For a
  CUDA ``fat`` it checks the operands and launches the kernel on PyTorch's
  current stream, or raises; there is no fallback.  For a CPU ``fat`` it
  runs :func:`fat_line_update_routed_plain`.  Its ``launches`` attribute
  counts kernel launches only; ``plain_runs`` counts the plain-version runs
  on the CPU.
* :func:`fat_line_update_routed_plain` transcribes the reference's XLA
  fallback: scatter ``g_u`` into the ``C x R`` slot space with a touched
  mask (:func:`routed_to_slots`), then ``fat_line_update_plain``'s packed
  form.  Like that fallback
  it reads the current rows from ``fat``; the kernel reads them from
  ``lines``, which holds the same values on the path (the forward gathered
  them from ``fat`` and nothing wrote ``fat`` since).  The CPU path and the
  kernel's oracle.

Both update ``fat`` IN PLACE and return it.  The bf16 stochastic-rounding
writeback of the TPU kernel is not ported (``ROADMAP.md`` Queue A item 13):
both refuse a non-f32 table.
"""

from __future__ import annotations

import ctypes

import torch

from tdfo_tpu_torch.ops.fat_lines import LANE, LineLayout
from tdfo_tpu_torch.ops.kernels.fat_line_update import (
    KIND_CODES,
    fat_line_update_plain,
)

__all__ = ["fat_line_update_routed", "fat_line_update_routed_plain",
           "routed_to_slots"]


def _check(fat, lines, ulines, row_lidx, row_slot, g_u, corr,
           layout: LineLayout) -> None:
    for name, t in (("fat", fat), ("lines", lines), ("g_u", g_u)):
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"fat_line_update_routed: {name} is {t.dtype}; non-f32 fat "
                "lines need the bf16/SR writeback, which is not ported yet "
                "(ROADMAP.md Queue A item 13)")
    trail = (layout.tiles, LANE)
    if fat.dim() != 3 or tuple(fat.shape[1:]) != trail:
        raise ValueError(f"fat must be [L, {layout.tiles}, {LANE}], got "
                         f"{tuple(fat.shape)}")
    for name, t in (("ulines", ulines), ("row_lidx", row_lidx),
                    ("row_slot", row_slot)):
        if t.dim() != 1 or t.dtype != torch.int32:
            raise ValueError(f"{name} must be 1-D int32, got {t.dtype} "
                             f"{tuple(t.shape)}")
    c, cr = ulines.shape[0], row_lidx.shape[0]
    if tuple(lines.shape) != (c, *trail):
        raise ValueError(f"lines must be [{c}, {layout.tiles}, {LANE}], got "
                         f"{tuple(lines.shape)}")
    if row_slot.shape[0] != cr or tuple(g_u.shape) != (cr, layout.d):
        raise ValueError(f"row_slot must be [{cr}] and g_u [{cr}, {layout.d}],"
                         f" got {tuple(row_slot.shape)} and {tuple(g_u.shape)}")
    if tuple(corr.shape) != (2,) or corr.dtype != torch.float32:
        raise ValueError("corr must be f32 [2]")


def routed_to_slots(ulines, row_lidx, row_slot, g_u, layout: LineLayout):
    """The routed update in ``fat_line_update``'s packed slot space:
    ``(g_slots [C, R, d], touched [C, R] f32)``, distinct row ``i``'s grads
    at slot ``(row_lidx[i], row_slot[i])``; padding rows are dropped."""
    c, r, d = ulines.shape[0], layout.r, layout.d
    lidx = row_lidx.to(torch.int64)
    slot = row_slot.to(torch.int64)
    keep = (lidx >= 0) & (lidx < c) & (slot >= 0) & (slot < r)
    slotidx = (lidx * r + slot)[keep]
    g_slots = torch.zeros((c * r, d), dtype=torch.float32, device=g_u.device)
    g_slots[slotidx] = g_u[keep]
    touched = torch.zeros((c * r,), dtype=torch.float32, device=g_u.device)
    touched[slotidx] = 1.0
    return g_slots.view(c, r, d), touched.view(c, r)


def fat_line_update_routed_plain(fat, lines, ulines, row_lidx, row_slot, g_u,
                                 corr, *, layout: LineLayout, lr: float,
                                 b1: float = 0.9, b2: float = 0.999,
                                 eps: float = 1e-8, weight_decay: float = 0.0):
    """Plain PyTorch version (same operands and contract as
    :func:`fat_line_update_routed`).  Updates ``fat`` in place; returns it."""
    _check(fat, lines, ulines, row_lidx, row_slot, g_u, corr, layout)
    g_slots, touched = routed_to_slots(ulines, row_lidx, row_slot, g_u, layout)
    return fat_line_update_plain(
        fat, ulines, g_slots, touched, corr, layout=layout, lr=lr, b1=b1,
        b2=b2, eps=eps, weight_decay=weight_decay)


def _launch(fat, lines, ulines, row_lidx, row_slot, g_u, corr, *, layout, lr,
            b1, b2, eps, weight_decay):
    from tdfo_tpu_torch.ops.kernels.build import load

    dev = fat.device
    for name, t in (("fat", fat), ("lines", lines), ("ulines", ulines),
                    ("row_lidx", row_lidx), ("row_slot", row_slot),
                    ("g_u", g_u), ("corr", corr)):
        if t.device != dev:
            raise ValueError(
                f"fat_line_update_routed: {name} on {t.device}, fat on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"fat_line_update_routed: {name} must be contiguous")
    fn = load("fat_line_update_routed").fat_line_update_routed_f32
    if fn.argtypes is None:
        vp, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_float)
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, i64, i64, i64, i32, i32,
                       i32, i32, f32, f32, f32, f32, f32, f32, f32, vp]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(fat.data_ptr(), lines.data_ptr(), ulines.data_ptr(),
                 row_lidx.data_ptr(), row_slot.data_ptr(), g_u.data_ptr(),
                 corr.data_ptr(), fat.shape[0], ulines.shape[0],
                 row_lidx.shape[0], layout.r, layout.w, layout.d,
                 KIND_CODES[layout.kind], lr, b1, b2, 1 - b1, 1 - b2, eps,
                 weight_decay, stream)
    if err != 0:
        raise RuntimeError(
            f"fat_line_update_routed kernel launch failed: CUDA error {err}")


def fat_line_update_routed(fat, lines, ulines, row_lidx, row_slot, g_u, corr,
                           *, layout: LineLayout, lr: float, b1: float = 0.9,
                           b2: float = 0.999, eps: float = 1e-8,
                           weight_decay: float = 0.0):
    """In-place fused optimizer step on the distinct rows of a dedup-lookup
    step.  ``fat [L, T, 128]`` f32; ``lines [C, T, 128]`` f32, the gather of
    ``fat`` at ``ulines``; ``ulines [C]``, ``row_lidx [CR]``, ``row_slot
    [CR]`` int32 from ``dedupe_rows_and_lines``; ``g_u [CR, d]`` f32 summed
    grads per distinct row; ``corr [2]`` f32 adam bias corrections (unused
    by the other kinds).  CUDA tensors launch the kernel; CPU tensors run
    the plain version.  Returns ``fat``."""
    kw = dict(layout=layout, lr=lr, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
    args = (fat, lines, ulines, row_lidx, row_slot, g_u, corr)
    if fat.device.type == "cpu":
        fat_line_update_routed.plain_runs += 1
        return fat_line_update_routed_plain(*args, **kw)
    if fat.device.type != "cuda":
        raise ValueError(
            f"fat_line_update_routed: unsupported device {fat.device}")
    _check(*args, layout)
    _launch(*args, **kw)
    fat_line_update_routed.launches += 1
    return fat


fat_line_update_routed.launches = 0
fat_line_update_routed.plain_runs = 0
