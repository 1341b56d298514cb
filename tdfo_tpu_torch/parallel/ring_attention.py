"""Ring attention over the ``seq`` mesh axis — port of
``tdfo_tpu/parallel/ring_attention.py`` (``_accum_chunk``,
``ring_attention``, ``_merge_flash``, ``ring_flash_attention``,
``ring_self_attention``, ``make_ring_attn_fn``).

The sequence splits over the P ranks of this rank's seq group; each holds
its chunk of queries, keys and values, and the K/V chunks travel the ring
(``parallel.collectives.Ppermute``: to ``(i + 1) % P``, from ``(i - 1) %
P``), so step ``s`` attends to the chunk that rank ``(i - s) % P`` owns.
Softmax statistics are f32 whatever the operands; a query row whose keys
are all masked gives 0.

* :func:`ring_attention`: the blockwise ring in plain torch, its online
  softmax differentiated by autograd.  ``block_k`` also chunks each step's
  local keys, each chunk under ``torch.utils.checkpoint`` (the reference's
  ``jax.checkpoint``), so the backward holds the carry, not every chunk's
  probabilities.
* :func:`ring_flash_attention`: the port's flash kernels
  (``ops/kernels/flash_attention.py``) inside each ring step, as one
  ``autograd.Function``.  Forward: ``flash_attention_with_lse`` per step,
  merged by the online-softmax rule (:func:`_merge_flash`; the kernel's
  ``+inf`` lse of a fully masked row counts as ``-inf``, no keys seen, in
  the merge and goes back to ``+inf`` in the residual).  Backward: the dQ
  and dK/dV kernels per step against the final output and lse, with
  ``delta = rowsum(dO * O)`` taken once; dK and dV ride the ring with
  their chunk and are home after a full lap.  P launches of each kernel
  a layer a step.  On a ring of one it is the flash path bitwise (one
  merge, with weights 0 and ``exp(0)``).
* :func:`ring_self_attention` takes tensors replicated over the seq axis
  (the whole sequence), runs the ring on this rank's chunk and gathers the
  result (:class:`~tdfo_tpu_torch.parallel.collectives.SeqScatter` /
  ``SeqGather``: the chunks' gradients are gathered on the way back, so the
  replicated work upstream sees the whole gradient).  ``head_axis`` and
  ``batch_axis`` mean what the reference's do: the heads (and the batch
  rows, when they divide) split over those axes around the ring and are
  gathered after.  :func:`make_ring_attn_fn` adapts it to the
  ``attn_fn(q, k, v, mask)`` contract of ``models/transformer.py``.

The merge and the rotation are plain torch and ``torch.distributed``, as
they are plain XLA in the reference.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from tdfo_tpu_torch.core.mesh import SEQ_AXIS, axis_group, axis_size
from tdfo_tpu_torch.parallel.collectives import (
    Ppermute,
    SeqGather,
    SeqScatter,
    ring_shift,
)

__all__ = ["make_ring_attn_fn", "ring_attention", "ring_flash_attention",
           "ring_self_attention"]

_NEG_INF = float(torch.finfo(torch.float32).min)


def _accum_chunk(o, m, l, q, k_blk, v_blk, kv_valid, scale):
    """One online-softmax accumulation over a K/V chunk: running output
    ``o``, row max ``m``, normaliser ``l``."""
    logits = torch.einsum("bhtd,bhsd->bhts", q, k_blk).to(torch.float32) * scale
    valid = kv_valid[:, None, None, :]
    logits = torch.where(valid, logits, _NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    # rows with every key so far masked keep m at _NEG_INF: their shift
    # is 0 and their correction 0, so exp cannot overflow
    shift = torch.where(m_new <= _NEG_INF / 2, 0.0, m_new)
    probs = torch.where(valid, torch.exp(logits - shift[..., None]), 0.0)
    corr = torch.where(m <= _NEG_INF / 2, 0.0, torch.exp(m - shift))
    l_new = l * corr + probs.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum(
        "bhts,bhsd->bhtd", probs.to(v_blk.dtype), v_blk).to(torch.float32)
    return o_new, m_new, l_new


def ring_attention(q, k, v, key_valid=None, *, group=None,
                   block_k: int | None = None) -> torch.Tensor:
    """Blockwise attention with an online softmax over the ring of
    ``group`` (None: a ring of one).  ``q, k, v: [B, H, Tq|Tk, Dh]`` are
    this rank's chunks, ``key_valid [B, Tk]`` (True = attend) its keys'
    validity.  ``block_k`` must divide the local Tk (0, None or >= Tk: one
    chunk a step)."""
    p = 1 if group is None else torch.distributed.get_world_size(group)
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    if key_valid is None:
        key_valid = torch.ones((b, tk), dtype=torch.bool, device=q.device)
    if not block_k or block_k >= tk:
        block_k = None
    elif tk % block_k:
        raise ValueError(f"block_k {block_k} must divide the local K length {tk}")
    o = torch.zeros((b, h, tq, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    k_blk, v_blk, valid = k, v, key_valid
    for s in range(p):
        if block_k is None:
            o, m, l = _accum_chunk(o, m, l, q, k_blk, v_blk, valid, scale)
        else:
            for c in range(tk // block_k):
                sl = slice(c * block_k, (c + 1) * block_k)
                o, m, l = checkpoint(_accum_chunk, o, m, l, q, k_blk[:, :, sl],
                                     v_blk[:, :, sl], valid[:, sl], scale,
                                     use_reentrant=False)
        if s < p - 1:  # the last step's chunks need not travel on
            k_blk, v_blk = Ppermute.apply(torch.stack((k_blk, v_blk)), group).unbind(0)
            valid = ring_shift(valid, group)
    out = torch.where(l[..., None] > 0, o / torch.clamp(l[..., None], min=1e-30), 0.0)
    return out.to(q.dtype)


def _merge_flash(o, lse, o_c, lse_c):
    """Online-softmax merge of two partial results; ``lse = -inf`` marks
    "no keys seen yet" (the kernel's ``+inf`` for a fully masked row is
    turned into it).  All f32."""
    lse_c = torch.where(torch.isposinf(lse_c), -math.inf, lse_c)
    new = torch.logaddexp(lse, lse_c)
    # exp(-inf - -inf) is nan: an empty side weighs 0
    w0 = torch.where(torch.isneginf(lse), 0.0, torch.exp(lse - new))
    w1 = torch.where(torch.isneginf(lse_c), 0.0, torch.exp(lse_c - new))
    return o * w0[..., None] + o_c * w1[..., None], new


def _rotate_pair(a, b, group):
    """Two same-dtype tensors of one shape around the ring in one call."""
    both = ring_shift(torch.stack((a, b)), group)
    return both[0], both[1]


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_valid, group):
        from tdfo_tpu_torch.ops.kernels.flash_attention import flash_attention_with_lse

        p = 1 if group is None else torch.distributed.get_world_size(group)
        b, h, tq, dh = q.shape
        o = torch.zeros((b, h, tq, dh), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, tq), -math.inf, dtype=torch.float32, device=q.device)
        k_blk, v_blk, valid = k, v, key_valid
        for s in range(p):
            o_c, lse_c = flash_attention_with_lse(q, k_blk, v_blk, valid)
            o, lse = _merge_flash(o, lse, o_c.to(torch.float32), lse_c)
            if s < p - 1:
                k_blk, v_blk = _rotate_pair(k_blk, v_blk, group)
                valid = ring_shift(valid, group)
        empty = torch.isneginf(lse)
        out = torch.where(empty[..., None], 0.0, o).to(q.dtype)
        # the flash backward's residual: +inf marks a fully masked row
        lse = torch.where(empty, math.inf, lse)
        ctx.group = group
        ctx.save_for_backward(q, k, v, key_valid, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        from tdfo_tpu_torch.ops.kernels.flash_attention import (
            flash_bwd_dkv,
            flash_bwd_dq,
        )

        q, k, v, key_valid, out, lse = ctx.saved_tensors
        group = ctx.group
        p = 1 if group is None else torch.distributed.get_world_size(group)
        g = g.to(q.dtype).contiguous()
        delta = (g.float() * out.float()).sum(dim=-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_blk, v_blk, valid = k, v, key_valid
        for s in range(p):
            dq += flash_bwd_dq(q, k_blk, v_blk, g, valid, lse, delta).float()
            dk_c, dv_c = flash_bwd_dkv(q, k_blk, v_blk, g, valid, lse, delta)
            dk += dk_c.float()
            dv += dv_c.float()
            # dK/dV ride with their chunk: after the full lap each is home
            # with every rank's contribution
            dk, dv = _rotate_pair(dk, dv, group) if p > 1 else (dk, dv)
            if s < p - 1:
                k_blk, v_blk = _rotate_pair(k_blk, v_blk, group)
                valid = ring_shift(valid, group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_flash_attention(q, k, v, key_valid=None, *, group=None) -> torch.Tensor:
    """Ring attention with the flash kernels inside each step (the module
    note); the arguments are :func:`ring_attention`'s."""
    if key_valid is None:
        key_valid = torch.ones((q.shape[0], k.shape[2]), dtype=torch.bool,
                               device=q.device)
    return _RingFlash.apply(q, k, v, key_valid, group)


def _group(mesh, axis):
    return None if axis_size(mesh, axis) == 1 else axis_group(mesh, axis)


def ring_self_attention(mesh, q, k, v, key_valid=None, *, axis: str = SEQ_AXIS,
                        block_k: int | None = None, head_axis: str | None = None,
                        batch_axis: str | None = None,
                        impl: str = "xla") -> torch.Tensor:
    """``[B, H, T, Dh]`` tensors (and ``key_valid [B, T]``) replicated over
    ``axis`` -> the attention ``[B, H, T, Dh]``, the sequence split over
    ``axis`` for the ring.  ``head_axis``: the heads also split over that
    axis (ring sequence parallelism composed with head parallelism; the
    heads must divide).  ``batch_axis``: the batch rows also split over
    that axis, unless they do not divide it.  ``impl``: ``"xla"``
    (:func:`ring_attention`, ``block_k`` chunking) or ``"flash"``
    (:func:`ring_flash_attention`)."""
    t = q.shape[2]
    n = axis_size(mesh, axis)
    if t % n:
        raise ValueError(f"sequence length {t} not divisible by seq axis {n}")
    if head_axis is not None and q.shape[1] % axis_size(mesh, head_axis):
        raise ValueError(
            f"heads {q.shape[1]} not divisible by {head_axis!r} axis "
            f"{axis_size(mesh, head_axis)} (ring + head parallelism)")
    if impl not in ("xla", "flash"):
        raise ValueError(f"unknown ring impl {impl!r}")
    if key_valid is None:
        key_valid = torch.ones((q.shape[0], t), dtype=torch.bool, device=q.device)
    b_ax = batch_axis
    if b_ax is not None and (axis_size(mesh, b_ax) <= 1
                             or q.shape[0] % axis_size(mesh, b_ax)):
        b_ax = None  # odd batches stay whole, as in the reference
    # (group, dim of q/k/v, dim of key_valid), outermost first
    splits = [(_group(mesh, a), dq, dv) for a, dq, dv in
              ((b_ax, 0, 0), (head_axis, 1, None), (axis, 2, 1)) if a is not None]
    splits = [s for s in splits if s[0] is not None]
    qkv = torch.stack((q, k, v))  # one gather of the three gradients
    for grp, d, dv in splits:
        qkv = SeqScatter.apply(qkv, grp, d + 1)
        if dv is not None:
            key_valid = SeqScatter.apply(key_valid, grp, dv)
    group = _group(mesh, axis)
    if impl == "flash":
        out = ring_flash_attention(*qkv.unbind(0), key_valid, group=group)
    else:
        out = ring_attention(*qkv.unbind(0), key_valid, group=group,
                             block_k=block_k)
    for grp, d, _ in reversed(splits):
        out = SeqGather.apply(out, grp, d)
    return out


def make_ring_attn_fn(mesh, axis: str = SEQ_AXIS, block_k: int | None = None,
                      head_axis: str | None = None,
                      batch_axis: str | None = None, impl: str = "xla"):
    """The ``attn_fn(q, k, v, mask)`` of ``models/transformer.py`` over
    :func:`ring_self_attention`; ``mask`` must be a key-padding mask
    ``[B, 1, 1, T]`` (query-dependent masks need the per-chunk API)."""

    def attn_fn(q, k, v, mask=None):
        key_valid = None
        if mask is not None:
            if mask.shape[1] != 1 or mask.shape[2] != 1:
                raise ValueError(
                    "ring attn_fn supports key-padding masks [B,1,1,T] only")
            key_valid = mask[:, 0, 0, :]
        return ring_self_attention(mesh, q, k, v, key_valid, axis=axis,
                                   block_k=block_k, head_axis=head_axis,
                                   batch_axis=batch_axis, impl=impl)

    return attn_fn
