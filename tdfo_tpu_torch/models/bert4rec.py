"""Bert4Rec — port of ``tdfo_tpu/models/bert4rec.py`` (``PAD_ID``,
``Bert4RecConfig``, ``key_padding_mask``, ``Bert4RecBackbone``,
``Bert4Rec``, ``init_bert4rec``, ``make_sharded_bert4rec``).

The item table lives in a
:class:`~tdfo_tpu_torch.parallel.embedding.ShardedEmbeddingCollection`
(``vocab = n_items + 2``: PAD 0, items 1..n, MASK n+1; fat fused storage
above ``fused_threshold`` rows); :class:`Bert4RecBackbone` takes the
gathered ``[B, T, d]`` item vectors: learned positional embedding,
LayerNorm, dropout, ``n_layers`` pre-norm transformer blocks, and the
``[B, T, V]`` output projection.  Parameter names equal the flax module's
(``pos_embed``, ``ln_in``, ``block_{i}.attn.qkv``, ..., ``out_proj``), so
``interop.backbone_params_from_flax`` loads a flax tree with
``load_state_dict(strict=True)``.

Attention cores: ``"full"`` (:func:`dot_product_attention`) and ``"flash"``
(the hand-written kernels of ``ops/kernels/flash_attention.py``; the key
mask reaches them as ``mask[:, 0, 0, :]``).  A fully masked query row
attends uniformly under ``"full"`` (softmax over equal fills) and outputs 0
under ``"flash"``; both packages agree on each.  ``"ring"`` and
``"ring_flash"`` wait for the multi-GPU slice.

:class:`Bert4Rec` is the self-contained model (its own ``[V, d]`` item
table, the reference's DDP branch) for ``train.step.make_train_step`` with
``train.seq.bert4rec_loss_fn``.  The trainer's ``model_parallel = false``
runs the sharded wiring with the table ``"replicated"``, as the reference's
trainer does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from tdfo_tpu_torch.core.device import resolve_device
from tdfo_tpu_torch.models.transformer import (
    TransformerBlock,
    dense,
    dot_product_attention,
    dropout,
    layer_norm,
)

__all__ = [
    "PAD_ID",
    "Bert4RecConfig",
    "Bert4RecBackbone",
    "key_padding_mask",
    "Bert4Rec",
    "flash_attn_fn",
    "init_bert4rec",
    "make_sharded_bert4rec",
]

PAD_ID = 0


@dataclass(frozen=True)
class Bert4RecConfig:
    """Hyperparameters; ``vocab_size = n_items + 2`` (PAD + items + MASK)."""

    n_items: int
    max_len: int = 20
    embed_dim: int = 64
    n_heads: int = 2
    n_layers: int = 2
    ff_mult: int = 4
    dropout: float = 0.1

    @property
    def vocab_size(self) -> int:
        return self.n_items + 2

    @property
    def mask_id(self) -> int:
        return self.n_items + 1


def key_padding_mask(item_ids: torch.Tensor) -> torch.Tensor:
    """[B, T] ids -> [B, 1, 1, T] attention mask (True = attend): keys at PAD
    are masked for every query."""
    return (item_ids != PAD_ID)[:, None, None, :]


def flash_attn_fn(q, k, v, mask=None):
    """The ``attn = "flash"`` core: key validity ``mask[:, 0, 0, :]`` into
    the flash kernels."""
    from tdfo_tpu_torch.ops.kernels.flash_attention import flash_attention

    return flash_attention(q, k, v, None if mask is None else mask[:, 0, 0, :])


class Bert4RecBackbone(nn.Module):
    """Everything after the item lookup: ``(item_embs [B, T, d], mask) ->
    logits [B, T, V]``.  Pass ``generator`` to the forward to enable
    dropout."""

    def __init__(self, cfg: Bert4RecConfig, attn_fn=dot_product_attention,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_len, d))
        nn.init.normal_(self.pos_embed, std=0.02, generator=generator)
        self.ln_in = layer_norm(d)
        for i in range(cfg.n_layers):
            setattr(self, f"block_{i}", TransformerBlock(
                d, cfg.n_heads, cfg.ff_mult * d, cfg.dropout, attn_fn, generator))
        self.out_proj = dense(d, cfg.vocab_size, generator)

    def forward(self, item_embs, mask=None, generator=None):
        t = item_embs.shape[1]
        h = item_embs + self.pos_embed[None, :t]
        h = dropout(self.ln_in(h), self.cfg.dropout, generator)
        for i in range(self.cfg.n_layers):
            h = getattr(self, f"block_{i}")(h, mask, generator)
        return self.out_proj(h)


class Bert4Rec(nn.Module):
    """Item ids ``[B, T] -> logits [B, T, V]``: the ``item_embed`` table
    (``U(-init_scale, init_scale)``, the DMP path's init), then the
    backbone.  Pass ``generator`` to enable dropout."""

    def __init__(self, cfg: Bert4RecConfig, attn_fn=dot_product_attention,
                 generator: torch.Generator | None = None,
                 init_scale: float = 1.0):
        super().__init__()
        self.cfg = cfg
        self.item_embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        nn.init.uniform_(self.item_embed.weight, -init_scale, init_scale,
                         generator=generator)
        self.backbone = Bert4RecBackbone(cfg, attn_fn, generator=generator)

    def forward(self, item_ids, generator=None):
        from tdfo_tpu_torch.parallel.embedding import embedding_lookup

        h = embedding_lookup(self.item_embed.weight, item_ids)
        return self.backbone(h, key_padding_mask(item_ids), generator=generator)


def init_bert4rec(cfg: Bert4RecConfig, *, seed: int = 0,
                  device="cuda") -> Bert4Rec:
    """A :class:`Bert4Rec` (full attention, as the reference's) drawn from
    ``seed`` on ``device`` (the card unless the caller asks for the
    CPU)."""
    gen = torch.Generator().manual_seed(int(seed))
    return Bert4Rec(cfg, generator=gen).to(resolve_device(device))


def make_sharded_bert4rec(cfg: Bert4RecConfig, *, seed: int = 0,
                          sharding: str = "row", attn: str = "full",
                          fused_threshold: int | None = 16384,
                          fused_kind: str = "adam", device="cuda"):
    """The DMP wiring: the item table in a collection (feature ``item``,
    init ``U(-1, 1)``, fat above ``fused_threshold``), the backbone dense.
    Returns ``(collection, tables, backbone)`` on ``device``; tables draw
    from ``seed``, the backbone from ``seed + 1``."""
    from tdfo_tpu_torch.parallel.embedding import (
        EmbeddingSpec,
        ShardedEmbeddingCollection,
    )

    if attn in ("ring", "ring_flash"):
        raise NotImplementedError(
            f"attn = {attn!r} (ring attention over a sequence mesh axis) is not "
            "ported to tdfo_tpu_torch yet (ROADMAP.md Queue A item 12)")
    attn_fns = {"full": dot_product_attention, "flash": flash_attn_fn}
    if attn not in attn_fns:
        raise ValueError(f"unknown attn {attn!r}")
    coll = ShardedEmbeddingCollection([EmbeddingSpec(
        "item_embedding", num_embeddings=cfg.vocab_size,
        embedding_dim=cfg.embed_dim, features=("item",), sharding=sharding,
        init_scale=1.0,
        fused=(fused_threshold is not None
               and sharding in ("row", "replicated")
               and cfg.vocab_size > fused_threshold))], fused_kind=fused_kind)
    device = resolve_device(device)
    tables = coll.init(seed, device=device)
    gen = torch.Generator().manual_seed(seed + 1)
    backbone = Bert4RecBackbone(cfg, attn_fns[attn], generator=gen).to(device)
    return coll, tables, backbone
