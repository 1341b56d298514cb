"""Flash attention: hand-written CUDA kernels for Hopper
(``ops/csrc/flash_attn_fwd.cu``, ``ops/csrc/flash_attn_bwd.cu``) plus their
plain PyTorch versions.

Port of ``tdfo_tpu/ops/pallas_kernels.py::flash_attention`` (the custom-VJP
function), ``_flash_fwd_impl`` / ``_flash_kernel`` and ``_flash_bwd_impl``
with its dQ and dK/dV kernels.

* :func:`flash_attention` ``(q, k, v, key_valid=None)``, ``q, k, v: [B, H,
  T, Dh]``, ``key_valid: [B, T]`` bool (True = attend).  Under autograd it is
  the :class:`FlashAttention` function: the forward saves ``(q, k, v,
  key_valid, out, lse)``, the backward launches the dQ and dK/dV kernels.
  Without grad (eval) it takes the inference forward, which writes no lse.
* :func:`flash_attention_with_lse` and :func:`flash_attention_bwd` are the
  same two halves as plain functions, for callers that combine partial
  attentions themselves (the ring path, ``ROADMAP.md`` Queue A item 12).
* The kernel wrappers :func:`flash_fwd`, :func:`flash_bwd_dq` and
  :func:`flash_bwd_dkv` launch the kernel for CUDA tensors or raise; for CPU
  tensors they run the plain versions :func:`flash_fwd_plain`,
  :func:`flash_bwd_dq_plain` and :func:`flash_bwd_dkv_plain`.  Each wrapper
  counts its kernel launches in ``.launches`` and its plain-version runs on
  the CPU in ``.plain_runs``.

The plain versions materialise ``[B, H, T, T]`` in f32 and follow the
reference rule for rule: masked logits are ``finfo(f32).min`` after the
scale multiply; a fully masked row gives output 0 and ``lse = +inf`` (and
zero gradients); ``p`` is rounded to the V dtype before ``P V`` and to the
dO dtype before ``P^T dO``; ``ds`` is rounded to the K/Q dtype; ``scale``
multiplies dQ and dK once more at the end but not dV.  The backward
versions rebuild ``p`` from ``lse`` and take ``delta = rowsum(dO * O)`` as
the kernels do; they are not autograd of the plain forward.  lse is
``[B, H, T]`` f32 (the reference's ``[B, H, 8, T]`` is a TPU layout).

Operands: f32 or bf16 (one type for q, k, v and dO), any T, any ``Dh <= 128``
that is a multiple of 8; anything else raises, on either device.
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = [
    "NEG_INF",
    "FlashAttention",
    "flash_attention",
    "flash_attention_with_lse",
    "flash_attention_bwd",
    "flash_fwd",
    "flash_bwd_dq",
    "flash_bwd_dkv",
    "flash_fwd_plain",
    "flash_bwd_dq_plain",
    "flash_bwd_dkv_plain",
]

NEG_INF = float(torch.finfo(torch.float32).min)  # pallas_kernels.py:65
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, key_valid, *extra) -> None:
    if q.dim() != 4:
        raise ValueError(f"flash attention: q must be [B, H, T, Dh], got {tuple(q.shape)}")
    b, h, t, dh = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention: dtype {q.dtype} (f32 or bf16 only)")
    if dh > 128 or dh % 8 or t < 1:
        raise ValueError(
            f"flash attention: Dh = {dh}, T = {t}; the kernels take T >= 1 "
            "and Dh <= 128 a multiple of 8")
    for name, x in (("k", k), ("v", v), *extra):
        if tuple(x.shape) != tuple(q.shape) or x.dtype != q.dtype:
            raise ValueError(f"flash attention: {name} is {x.dtype} "
                             f"{tuple(x.shape)}, q is {q.dtype} {tuple(q.shape)}")
    if key_valid.dtype != torch.bool or tuple(key_valid.shape) != (b, t):
        raise ValueError(f"flash attention: key_valid must be bool [{b}, {t}], "
                         f"got {key_valid.dtype} {tuple(key_valid.shape)}")
    for name, x in (("k", k), ("v", v), ("key_valid", key_valid), *extra):
        if x.device != q.device:
            raise ValueError(f"flash attention: {name} on {x.device}, q on {q.device}")


def _check_rows(name, x, like) -> None:
    """lse / delta: f32 ``[B, H, T]`` on the device of ``like``."""
    if x.dtype != torch.float32 or tuple(x.shape) != tuple(like.shape[:3]):
        raise ValueError(f"flash attention: {name} must be f32 "
                         f"{tuple(like.shape[:3])}, got {x.dtype} {tuple(x.shape)}")
    if x.device != like.device:
        raise ValueError(f"flash attention: {name} on {x.device}, q on {like.device}")


def _scale(q) -> float:
    return 1.0 / math.sqrt(q.shape[-1])


# ------------------------------------------------------------ plain versions


def _logits(q, k, key_valid):
    """scale * q k^T in f32 with masked keys at NEG_INF: ``[B, H, T, T]``."""
    s = _scale(q) * torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
    return torch.where(key_valid[:, None, None, :], s, NEG_INF)


def flash_fwd_plain(q, k, v, key_valid, with_lse: bool = True):
    """Plain version of the forward kernel: ``(out, lse)`` (lse None when
    ``with_lse`` is false)."""
    _check(q, k, v, key_valid)
    valid = key_valid[:, None, None, :]
    s = _logits(q, k, key_valid)
    m = s.amax(dim=-1, keepdim=True)
    shift = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.where(valid, torch.exp(s - shift), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhts,bhsd->bhtd", p.to(v.dtype).float(), v.float())
    out = torch.where(l > 0, acc / l.clamp_min(1e-30), 0.0).to(q.dtype)
    if not with_lse:
        return out, None
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), math.inf)
    return out, lse[..., 0]


def _probs(q, k, key_valid, lse):
    """p rebuilt from the saved logsumexp (0 on masked keys and on fully
    masked rows, whose lse is +inf)."""
    return torch.exp(_logits(q, k, key_valid) - lse[..., None])


def _ds(p, do, v, delta, dtype):
    dp = torch.einsum("bhtd,bhsd->bhts", do.float(), v.float())
    return (p * (dp - delta[..., None])).to(dtype).float()


def flash_bwd_dq_plain(q, k, v, do, key_valid, lse, delta):
    """Plain version of the dQ kernel."""
    _check(q, k, v, key_valid, ("dO", do))
    p = _probs(q, k, key_valid, lse)
    ds = _ds(p, do, v, delta, k.dtype)
    return (_scale(q) * torch.einsum("bhts,bhsd->bhtd", ds, k.float())).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, key_valid, lse, delta):
    """Plain version of the dK/dV kernel: ``(dk, dv)``."""
    _check(q, k, v, key_valid, ("dO", do))
    p = _probs(q, k, key_valid, lse)
    dv = torch.einsum("bhts,bhtd->bhsd", p.to(do.dtype).float(), do.float())
    ds = _ds(p, do, v, delta, q.dtype)
    dk = _scale(q) * torch.einsum("bhts,bhtd->bhsd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ kernel wrappers


def _fn(lib_name: str, sym: str, n_ptrs: int):
    from tdfo_tpu_torch.ops.kernels.build import load

    fn = getattr(load(lib_name), sym)
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([i32] + [vp] * n_ptrs + [i32] * 4
                       + [ctypes.c_float, vp])
        fn.restype = ctypes.c_int
    return fn


def _launch(sym, lib_name, q, ptrs, key):
    b, h, t, dh = q.shape
    fn = _fn(lib_name, sym, len(ptrs))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPES[q.dtype], *ptrs, b, h, t, dh, _scale(q), stream)
    if err != 0:
        raise RuntimeError(f"{key} kernel launch failed: CUDA error {err}")


def _aligned16(x):
    """``x``, or a copy of it where its data does not start on 16 bytes (the
    kernels stage and store with 16-byte accesses)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _device_kind(q, what):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q.device}")
    return q.device.type


def flash_fwd(q, k, v, key_valid, with_lse: bool = True):
    """Forward kernel: ``(out [B, H, T, Dh] like q, lse [B, H, T] f32 or
    None)``.  ``with_lse=False`` is the inference call (no lse write)."""
    _check(q, k, v, key_valid)
    if _device_kind(q, "flash_fwd") == "cpu":
        flash_fwd.plain_runs += 1
        return flash_fwd_plain(q, k, v, key_valid, with_lse)
    q, k, v, key_valid = (x.contiguous() for x in (q, k, v, key_valid))
    q, k, v = (_aligned16(x) for x in (q, k, v))
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch("flash_attn_fwd", "flash_attn_fwd", q,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
             out.data_ptr(), None if lse is None else lse.data_ptr()],
            "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, do, key_valid, lse, delta):
    """dQ kernel (FA-2 recompute from ``lse`` and ``delta``)."""
    _check(q, k, v, key_valid, ("dO", do))
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    if _device_kind(q, "flash_bwd_dq") == "cpu":
        flash_bwd_dq.plain_runs += 1
        return flash_bwd_dq_plain(q, k, v, do, key_valid, lse, delta)
    q, k, v, do, key_valid, lse, delta = (
        x.contiguous() for x in (q, k, v, do, key_valid, lse, delta))
    q, k, v, do = (_aligned16(x) for x in (q, k, v, do))
    dq = torch.empty_like(q)
    _launch("flash_attn_bwd_dq", "flash_attn_bwd", q,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             key_valid.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dq.data_ptr()], "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, key_valid, lse, delta):
    """dK/dV kernel: ``(dk, dv)``."""
    _check(q, k, v, key_valid, ("dO", do))
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    if _device_kind(q, "flash_bwd_dkv") == "cpu":
        flash_bwd_dkv.plain_runs += 1
        return flash_bwd_dkv_plain(q, k, v, do, key_valid, lse, delta)
    q, k, v, do, key_valid, lse, delta = (
        x.contiguous() for x in (q, k, v, do, key_valid, lse, delta))
    q, k, v, do = (_aligned16(x) for x in (q, k, v, do))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attn_bwd_dkv", "flash_attn_bwd", q,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             key_valid.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dk.data_ptr(), dv.data_ptr()], "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
flash_fwd.plain_runs = 0
flash_bwd_dq.plain_runs = 0
flash_bwd_dkv.plain_runs = 0


# ------------------------------------------------------------ public function


def _valid_or_all(q, key_valid):
    if key_valid is None:
        return torch.ones((q.shape[0], q.shape[2]), dtype=torch.bool,
                          device=q.device)
    return key_valid


def flash_attention_with_lse(q, k, v, key_valid=None):
    """Forward with its logsumexp residual: ``(out, lse)``."""
    return flash_fwd(q, k, v, _valid_or_all(q, key_valid), with_lse=True)


def flash_attention_bwd(q, k, v, key_valid, out, lse, g):
    """Backward from the forward's ``(out, lse)`` and the output gradient
    ``g``: ``(dq, dk, dv)``.  ``delta = rowsum(dO * O)`` is a torch
    expression, outside the kernels, as in the reference."""
    key_valid = _valid_or_all(q, key_valid)
    g = g.to(q.dtype)
    delta = (g.float() * out.float()).sum(dim=-1)
    dq = flash_bwd_dq(q, k, v, g, key_valid, lse, delta)
    dk, dv = flash_bwd_dkv(q, k, v, g, key_valid, lse, delta)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``_flash_fwd`` / ``_flash_bwd`` of the reference's custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid):
        out, lse = flash_fwd(q, k, v, key_valid, with_lse=True)
        ctx.save_for_backward(q, k, v, key_valid, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_valid, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, key_valid, out, lse, g)
        return dq, dk, dv, None


def flash_attention(q, k, v, key_valid=None):
    """Blockwise attention with an online softmax (reference
    ``flash_attention``).  Differentiable in ``q, k, v``; without grad it
    runs the inference forward (no lse)."""
    key_valid = _valid_or_all(q, key_valid)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, key_valid)
    return flash_fwd(q, k, v, key_valid, with_lse=False)[0]
