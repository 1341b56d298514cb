"""TwoTower CTR model — port of ``tdfo_tpu/models/twotower.py`` (``Tower``,
``TwoTower``, ``init_twotower``, ``TwoTowerBackbone``,
``ctr_embedding_specs``).

:class:`TwoTower` is the dense regime (``model_parallel = false``, the
quickstart's): it owns its 7 tables as ``[V, d]`` embeddings and trains
every parameter under AdamW.  A lookup is ``jnp.take``'s default
(``mode="fill"``, ``parallel.embedding.embedding_lookup``): an id in
``[-V, V)`` indexes numpy-style, any other reads NaN; its gradient is a
row-wise segment sum in input order (``ops/kernels/segment_sum.py``; no
host sync, so the step can be captured in a CUDA graph).  In the DMP regime the backbone
consumes already-gathered embedding vectors keyed by input
column (``user_id``, ``item_id``, ...) plus the raw batch for the two
continuous features; the tables live in a
:class:`~tdfo_tpu_torch.parallel.embedding.ShardedEmbeddingCollection`.
User tower = MLP over the user embedding; item tower = MLP over the concat
of the 6 item-side embeddings and the 2 scalars (input width ``6*d + 2``);
logit = row-wise dot product.  ``dtype`` is the compute dtype with flax
semantics: parameters stay f32, and the forward casts the inputs, weights
and biases to ``dtype`` (bf16 under ``mixed_precision`` as the reference's
bench computes, ``core/precision.py``), so the logits come out in
``dtype``.

Flax ``Dense.kernel`` is ``[in, out]``; ``nn.Linear.weight`` is
``[out, in]`` (``interop.backbone_params_from_flax`` transposes).
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

__all__ = [
    "Tower",
    "TwoTower",
    "TwoTowerBackbone",
    "TWOTOWER_CATEGORICAL",
    "TWOTOWER_CONTINUOUS",
    "FEATURE_TO_INPUT",
    "ctr_embedding_specs",
    "init_twotower",
]

# item-side categorical features, concat order fixed (reference order)
TWOTOWER_ITEM_CATEGORICAL = ("item", "language", "is_ebook", "format",
                             "publisher", "pub_decade")
TWOTOWER_CATEGORICAL = ("user",) + TWOTOWER_ITEM_CATEGORICAL
TWOTOWER_CONTINUOUS = ("avg_rating", "num_pages")

FEATURE_TO_INPUT = {
    "user": "user_id",
    "item": "item_id",
    "language": "language",
    "is_ebook": "is_ebook",
    "format": "format",
    "publisher": "publisher",
    "pub_decade": "pub_decade",
}


def dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: inputs, weight and bias cast to the
    compute dtype (the f32 parameters themselves stay f32)."""
    if dtype == torch.float32:
        return lin(x)
    return nn.functional.linear(x.to(dtype), lin.weight.to(dtype),
                                lin.bias.to(dtype))


class Tower(nn.Module):
    """Two-layer MLP head (fc1 -> SiLU -> fc2), output width = embed_dim;
    glorot-uniform weights and zero biases, as flax's ``Dense`` defaults."""

    def __init__(self, in_dim: int, embed_dim: int,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(in_dim, embed_dim)
        self.fc2 = nn.Linear(embed_dim, embed_dim)
        for lin in (self.fc1, self.fc2):
            nn.init.xavier_uniform_(lin.weight, generator=generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = nn.functional.silu(dense(self.fc1, x, self.dtype))
        return dense(self.fc2, h, self.dtype)


class TwoTower(nn.Module):
    """The dense regime's model: ``{feat}_embed`` tables (``[V, d]``,
    glorot-uniform, flax ``nn.Embed``'s init here) plus the two towers;
    ``batch -> logits [B]``.  Parameter names map one to one onto the flax
    tree (``interop.dense_params_from_flax``)."""

    def __init__(self, size_map: Mapping[str, int], embed_dim: int,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.dtype = dtype
        for feat in TWOTOWER_CATEGORICAL:
            emb = nn.Embedding(int(size_map[feat]), embed_dim)
            nn.init.xavier_uniform_(emb.weight, generator=generator)
            setattr(self, f"{feat}_embed", emb)
        self.user_tower = Tower(embed_dim, embed_dim, generator, dtype)
        in_item = len(TWOTOWER_ITEM_CATEGORICAL) * embed_dim + len(TWOTOWER_CONTINUOUS)
        self.item_tower = Tower(in_item, embed_dim, generator, dtype)

    def embed(self, feat: str, ids: torch.Tensor) -> torch.Tensor:
        from tdfo_tpu_torch.parallel.embedding import embedding_lookup

        return embedding_lookup(getattr(self, f"{feat}_embed").weight,
                                ids).to(self.dtype)

    def user_embeddings(self, x: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return self.user_tower(self.embed("user", x[FEATURE_TO_INPUT["user"]]))

    def item_embeddings(self, x: Mapping[str, torch.Tensor]) -> torch.Tensor:
        parts = [self.embed(f, x[FEATURE_TO_INPUT[f]])
                 for f in TWOTOWER_ITEM_CATEGORICAL]
        parts += [x[c].to(self.dtype)[:, None] for c in TWOTOWER_CONTINUOUS]
        return self.item_tower(torch.cat(parts, dim=-1))

    def forward(self, x: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return (self.user_embeddings(x) * self.item_embeddings(x)).sum(dim=-1)


def init_twotower(seed: int, size_map: Mapping[str, int], embed_dim: int,
                  dtype: torch.dtype = torch.float32, device="cpu") -> TwoTower:
    """A :class:`TwoTower` drawn from ``seed`` (a ``torch.Generator``; the
    draws differ from jax's, so parity tests inject the reference's params
    through ``interop.dense_params_from_flax``)."""
    gen = torch.Generator().manual_seed(int(seed))
    return TwoTower(size_map, embed_dim, generator=gen, dtype=dtype).to(device)


class TwoTowerBackbone(nn.Module):
    """Dense half of TwoTower for the DMP regime: ``(embs, batch) ->
    logits [B]``."""

    def __init__(self, embed_dim: int, generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.user_tower = Tower(embed_dim, embed_dim, generator, dtype)
        in_item = len(TWOTOWER_ITEM_CATEGORICAL) * embed_dim + len(TWOTOWER_CONTINUOUS)
        self.item_tower = Tower(in_item, embed_dim, generator, dtype)

    def forward(self, embs: Mapping[str, torch.Tensor],
                batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        dt = self.dtype
        u = self.user_tower(embs[FEATURE_TO_INPUT["user"]].to(dt))
        parts = [embs[FEATURE_TO_INPUT[f]].to(dt)
                 for f in TWOTOWER_ITEM_CATEGORICAL]
        parts += [batch[c].to(dt)[:, None] for c in TWOTOWER_CONTINUOUS]
        v = self.item_tower(torch.cat(parts, dim=-1))
        return (u * v).sum(dim=-1)


def ctr_embedding_specs(size_map: Mapping[str, int], embed_dim: int,
                        sharding: str = "row",
                        fused_threshold: int | None = 16384):
    """Declare the 7 CTR tables (table ``{feat}_embed`` serves its input
    column); init and fusion policy live in ``make_embedding_specs``."""
    from tdfo_tpu_torch.parallel.embedding import make_embedding_specs

    return make_embedding_specs(
        size_map,
        [(feat, f"{feat}_embed", FEATURE_TO_INPUT[feat])
         for feat in TWOTOWER_CATEGORICAL],
        embed_dim, sharding, fused_threshold,
    )
