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

Initialisation follows flax's defaults (``Dense``: truncated lecun-normal
weights, zero biases; ``LayerNorm``: ones and zeros) from an optional
``generator``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn
from torch.nn import functional as F

__all__ = [
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


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale by
    its inverse; the identity without a generator or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


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

    def forward(self, x, mask=None, generator=None):
        b, t, d = x.shape
        dh = d // self.n_heads
        # (head, qkv, dh) feature order, as the reference's reshape
        qkv = self.qkv(x).view(b, t, self.n_heads, 3, dh)
        q, k, v = qkv.permute(3, 0, 2, 1, 4).contiguous().unbind(0)  # [B,H,T,Dh]
        out = self.attn_fn(q, k, v, mask)
        out = out.transpose(1, 2).reshape(b, t, d)
        out = dropout(out, self.rate, generator)
        return self.out(out)


class FeedForward(nn.Module):
    """Position-wise FFN with the tanh-approximated GELU."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.rate = dropout
        self.fc1 = dense(dim, hidden_dim, generator)
        self.fc2 = dense(hidden_dim, dim, generator)

    def forward(self, x, generator=None):
        h = F.gelu(self.fc1(x), approximate="tanh")
        h = dropout(h, self.rate, generator)
        return self.fc2(h)


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
