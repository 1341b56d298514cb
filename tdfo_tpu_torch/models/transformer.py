"""Transformer blocks — port of ``tdfo_tpu/models/transformer.py``
(``dot_product_attention``, ``MultiHeadAttention``, ``FeedForward``,
``TransformerBlock``) as ``nn.Module`` s.

Kept from the reference: the fused QKV projection with its output features
in **(head, qkv, dh)** order (a flax checkpoint's fused kernel reads in
unchanged, ``interop.backbone_params_from_flax``), the f32 softmax with the
mask fill at ``finfo(f32).min``, pre-norm residual sublayers, and a
pluggable attention core ``attn_fn(q, k, v, mask)`` on ``[B, H, T, Dh]``
(``mask`` broadcastable to ``[B, H, T, S]``, True = attend).  Two flax
defaults are spelled out: ``nn.LayerNorm`` uses ``eps = 1e-6`` (torch's
default is 1e-5) and ``jax.nn.gelu`` is the tanh approximation (torch's
``F.gelu`` is exact unless asked).

Dropout is active only when a ``torch.Generator`` is passed (the
counterpart of the reference's ``dropout_rng``; without one every module is
deterministic, as flax's ``deterministic=True``).  It draws from that
generator, so a run is reproducible from its seed; the draws differ from
jax's, so parity tests run at dropout 0.

Megatron tensor parallelism (``ModelSplit``, set by
``models.bert4rec.Bert4RecBackbone.shard_tensor_parallel_``): a
:class:`MultiHeadAttention` whose fused qkv holds this rank's heads runs
them alone, between copy-to-model on its input and reduce-from-model after
its row-parallel output projection; a :class:`FeedForward` holds its
columns of ``fc1`` and rows of ``fc2`` the same way.  The row-parallel
biases are whole on every rank and added once, after the sum.

Dropout under a split: the mask is drawn at the global shape and sliced,
so a sharded run draws what one device draws.  Rows: the generator comes
as a :class:`RowShare` (this rank's share of the global batch's rows);
columns: the split sublayers pass their ``(parts, index)`` (the attention
heads, the FFN hidden units).

Initialisation follows flax's defaults (``Dense``: truncated lecun-normal
weights, zero biases; ``LayerNorm``: ones and zeros) from an optional
``generator``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

__all__ = [
    "ModelSplit",
    "RowShare",
    "dot_product_attention",
    "dropout",
    "dense",
    "layer_norm",
    "MultiHeadAttention",
    "FeedForward",
    "TransformerBlock",
]

LN_EPS = 1e-6  # flax nn.LayerNorm default
_MASK_FILL = float(torch.finfo(torch.float32).min)


def dot_product_attention(q, k, v, mask=None):
    """Scaled dot-product attention with an f32 softmax; masked logits are
    ``finfo(f32).min`` (a fully masked row attends uniformly, as in the
    reference)."""
    dh = q.shape[-1]
    logits = torch.einsum("bhtd,bhsd->bhts", q, k).to(torch.float32) / math.sqrt(dh)
    if mask is not None:
        logits = torch.where(mask, logits, _MASK_FILL)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", probs.to(v.dtype), v)


class RowShare(NamedTuple):
    """A dropout generator with this rank's share of the global batch:
    ``index`` of ``parts`` equal blocks of rows."""

    generator: torch.Generator
    parts: int
    index: int


class ModelSplit(NamedTuple):
    """A tensor-parallel sublayer's process group, its size and this rank's
    index in it."""

    group: Any
    size: int
    index: int


def _block(x: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    n = x.shape[dim] // parts
    return x.narrow(dim, index * n, n)


def dropout(x: torch.Tensor, rate: float, generator,
            cols: tuple[int, int] = (1, 0)) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale by
    its inverse; the identity without a generator or at rate 0.  A
    :class:`RowShare` generator, or ``cols = (parts, index)``, draws the
    mask at the global shape and keeps this rank's rows or columns."""
    if generator is None or rate == 0.0:
        return x
    rows = (1, 0)
    if isinstance(generator, RowShare):
        generator, *rows = generator
    keep_prob = 1.0 - rate
    shape = (x.shape[0] * rows[0], *x.shape[1:-1], x.shape[-1] * cols[0])
    keep = torch.rand(shape, generator=generator, device=x.device) < keep_prob
    if rows[0] > 1:
        keep = _block(keep, 0, *rows)
    if cols[0] > 1:
        keep = _block(keep, -1, *cols)
    return torch.where(keep, x / keep_prob, 0.0)


def _row_parallel(lin: nn.Linear, x, tp: ModelSplit):
    """``lin`` holding its input columns: the partial products summed over
    the model group, then the (whole) bias once."""
    from tdfo_tpu_torch.parallel.collectives import AllReduceSum

    return AllReduceSum.apply(F.linear(x, lin.weight), tp.group) + lin.bias


def _copy_in(x, tp: ModelSplit | None):
    from tdfo_tpu_torch.parallel.collectives import CopyToModel

    return x if tp is None else CopyToModel.apply(x, tp.group)


def dense(in_dim: int, out_dim: int,
          generator: torch.Generator | None = None) -> nn.Linear:
    """``nn.Linear`` with flax ``Dense``'s default init: lecun-normal
    truncated at two standard deviations, zero bias."""
    lin = nn.Linear(in_dim, out_dim)
    std = math.sqrt(1.0 / in_dim) / 0.87962566103423978  # truncation-corrected
    nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    nn.init.zeros_(lin.bias)
    return lin


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention with a fused QKV projection and a pluggable
    attention core."""

    def __init__(self, dim: int, n_heads: int, dropout: float = 0.1,
                 attn_fn: Callable = dot_product_attention,
                 generator: torch.Generator | None = None):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"dim {dim} not divisible by {n_heads} heads")
        self.n_heads = n_heads
        self.rate = dropout
        self.attn_fn = attn_fn
        self.qkv = dense(dim, 3 * dim, generator)
        self.out = dense(dim, dim, generator)
        self.tp: ModelSplit | None = None  # this rank's heads only

    def forward(self, x, mask=None, generator=None):
        b, t, d = x.shape
        tp = self.tp
        dh = d // self.n_heads
        heads = self.n_heads // (tp.size if tp else 1)
        # (head, qkv, dh) feature order, as the reference's reshape
        qkv = self.qkv(_copy_in(x, tp)).view(b, t, heads, 3, dh)
        q, k, v = qkv.permute(3, 0, 2, 1, 4).contiguous().unbind(0)  # [B,H,T,Dh]
        out = self.attn_fn(q, k, v, mask)
        out = out.transpose(1, 2).reshape(b, t, heads * dh)
        if tp is None:
            return self.out(dropout(out, self.rate, generator))
        out = dropout(out, self.rate, generator, cols=(tp.size, tp.index))
        return _row_parallel(self.out, out, tp)


class FeedForward(nn.Module):
    """Position-wise FFN with the tanh-approximated GELU."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.rate = dropout
        self.fc1 = dense(dim, hidden_dim, generator)
        self.fc2 = dense(hidden_dim, dim, generator)
        self.tp: ModelSplit | None = None  # this rank's hidden units only

    def forward(self, x, generator=None):
        tp = self.tp
        h = F.gelu(self.fc1(_copy_in(x, tp)), approximate="tanh")
        if tp is None:
            return self.fc2(dropout(h, self.rate, generator))
        h = dropout(h, self.rate, generator, cols=(tp.size, tp.index))
        return _row_parallel(self.fc2, h, tp)


class TransformerBlock(nn.Module):
    """Pre-norm residual block: ``x + dropout(sublayer(LN(x)))`` for
    attention, then the FFN."""

    def __init__(self, dim: int, n_heads: int, ff_dim: int,
                 dropout: float = 0.1,
                 attn_fn: Callable = dot_product_attention,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.rate = dropout
        self.ln_attn = layer_norm(dim)
        self.attn = MultiHeadAttention(dim, n_heads, dropout, attn_fn, generator)
        self.ln_ff = layer_norm(dim)
        self.ff = FeedForward(dim, ff_dim, dropout, generator)

    def forward(self, x, mask=None, generator=None):
        h = self.attn(self.ln_attn(x), mask, generator)
        x = x + dropout(h, self.rate, generator)
        h = self.ff(self.ln_ff(x), generator)
        return x + dropout(h, self.rate, generator)
