"""``segment_sum``: a deterministic segment sum, hand-written CUDA for Hopper
(``ops/csrc/segment_sum.cu``) plus its plain PyTorch version.

The port's own kernel (it replaces no TPU kernel).  Every place that sums
float contributions by index calls it: the gradient dedupe, the dense lazy
tier, the embedding gradient and the AUC histograms.  ``index_add_`` on the
card adds with atomics, so its sums came out in another order on every run;
this one adds each segment's members left to right from 0.0 in input order
(bf16/f16 in f32, rounded once), as the CPU's ``index_add_`` (and XLA's CPU
scatter) adds, so a card run repeats itself and equals the CPU bit for bit.

* :func:`segment_sum` is the wrapper every caller uses: ``x [N, ...]``,
  ``seg [N]`` int -> ``out [n, ...]`` with ``out[s] = sum x[seg == s]``;
  rows whose segment lies outside ``[0, n)`` are dropped.  A CPU ``x`` runs
  :func:`segment_sum_plain`; a CUDA ``x`` (f32, bf16 or f16) launches the
  kernel, or raises.  ``plan``: ``(order, sorted segments)``, a stable
  sort of ``seg`` the caller already has (a dedupe's), so it is not
  sorted twice.
  ``launches`` counts kernel launches, ``plain_runs`` CPU runs.
* :func:`segment_sum_plain` is ``index_add_`` into zeros: the CPU path and
  the kernel's oracle.
* :func:`segment_plan` is what the kernel is given: the rows' stable order
  by segment and each segment's ``[start, end)`` in it.
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["segment_plan", "segment_sum", "segment_sum_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def segment_sum_plain(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``index_add_`` of ``x``'s rows into ``n`` zero rows at ``seg``, rows
    of segments outside ``[0, n)`` dropped.  Always on a ``[N, d]`` view:
    the CPU's ``index_add_`` sums such a bf16/f16 tensor in f32 and rounds
    once (a 1-D one it rounds after every addition), which the kernel
    does too."""
    seg = seg.reshape(-1).to(torch.int64)
    keep = (seg >= 0) & (seg < n)
    tail = x.shape[1:]
    x2 = x.reshape(x.shape[0], math.prod(tail))
    out = torch.zeros((n, x2.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg[keep], x2[keep]).reshape(n, *tail)


def segment_plan(seg: torch.Tensor, n: int, plan=None):
    """``(order, offsets [n + 1])``: ``order`` a stable sort of ``seg``
    (``plan``'s, or a new one), segment ``s``'s members at
    ``order[offsets[s]:offsets[s + 1]]`` in input order.  Segments outside
    ``[0, n)`` fall outside every range."""
    if plan is None:
        sorted_seg, order = torch.sort(seg.reshape(-1).to(torch.int64), stable=True)
    else:
        order, sorted_seg = plan
    bounds = torch.arange(n + 1, dtype=torch.int64, device=seg.device)
    offsets = torch.searchsorted(sorted_seg.to(torch.int64).contiguous(), bounds)
    return order, offsets


def _launch(xs: torch.Tensor, offsets: torch.Tensor, out: torch.Tensor) -> None:
    from tdfo_tpu_torch.ops.kernels.build import load

    fn = load("segment_sum").segment_sum
    if fn.argtypes is None:
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [vp, vp, vp, i64, i64, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    dev = xs.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xs.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                 out.shape[0], xs.shape[1], _DTYPES[xs.dtype], stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error {err}")


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int,
                plan=None) -> torch.Tensor:
    """Deterministic ``jax.ops.segment_sum`` (out-of-range segments
    dropped): see the module note."""
    if x.device.type == "cpu":
        segment_sum.plain_runs += 1
        return segment_sum_plain(x, seg, n)
    if x.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"segment_sum: dtype {x.dtype} is not f32, bf16 or f16")
    if seg.device != x.device or seg.reshape(-1).shape[0] != x.shape[0]:
        raise ValueError("segment_sum: seg must be [N] on x's device")
    tail = x.shape[1:]
    order, offsets = segment_plan(seg, n, plan)
    xs = x.reshape(x.shape[0], math.prod(tail))[order].contiguous()
    out = torch.empty((n, xs.shape[1]), dtype=x.dtype, device=x.device)
    _launch(xs, offsets.contiguous(), out)
    segment_sum.launches += 1
    return out.reshape(n, *tail)


segment_sum.launches = 0
segment_sum.plain_runs = 0
