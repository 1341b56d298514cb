"""TwoTower CTR model, DMP regime — port of ``tdfo_tpu/models/twotower.py``
(``Tower``, ``TwoTowerBackbone``, ``ctr_embedding_specs``).

The backbone consumes already-gathered embedding vectors keyed by input
column (``user_id``, ``item_id``, ...) plus the raw batch for the two
continuous features; the tables live in a
:class:`~tdfo_tpu_torch.parallel.embedding.ShardedEmbeddingCollection`.
User tower = MLP over the user embedding; item tower = MLP over the concat
of the 6 item-side embeddings and the 2 scalars (input width ``6*d + 2``);
logit = row-wise dot product.  f32 compute only (``mixed_precision`` is not
ported yet, ``ROADMAP.md`` Queue A item 13).  The dense-regime ``TwoTower``
(tables inside the model) is not ported yet (``ROADMAP.md`` Queue A item 4).

Flax ``Dense.kernel`` is ``[in, out]``; ``nn.Linear.weight`` is
``[out, in]`` (``interop.backbone_params_from_flax`` transposes).
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

__all__ = [
    "Tower",
    "TwoTowerBackbone",
    "TWOTOWER_CATEGORICAL",
    "TWOTOWER_CONTINUOUS",
    "FEATURE_TO_INPUT",
    "ctr_embedding_specs",
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


class Tower(nn.Module):
    """Two-layer MLP head (fc1 -> SiLU -> fc2), output width = embed_dim;
    glorot-uniform weights and zero biases, as flax's ``Dense`` defaults."""

    def __init__(self, in_dim: int, embed_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, embed_dim)
        self.fc2 = nn.Linear(embed_dim, embed_dim)
        for lin in (self.fc1, self.fc2):
            nn.init.xavier_uniform_(lin.weight, generator=generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(nn.functional.silu(self.fc1(x)))


class TwoTowerBackbone(nn.Module):
    """Dense half of TwoTower for the DMP regime: ``(embs, batch) ->
    logits [B]``."""

    def __init__(self, embed_dim: int, generator: torch.Generator | None = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.user_tower = Tower(embed_dim, embed_dim, generator)
        in_item = len(TWOTOWER_ITEM_CATEGORICAL) * embed_dim + len(TWOTOWER_CONTINUOUS)
        self.item_tower = Tower(in_item, embed_dim, generator)

    def forward(self, embs: Mapping[str, torch.Tensor],
                batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        u = self.user_tower(embs[FEATURE_TO_INPUT["user"]].to(torch.float32))
        parts = [embs[FEATURE_TO_INPUT[f]].to(torch.float32)
                 for f in TWOTOWER_ITEM_CATEGORICAL]
        parts += [batch[c].to(torch.float32)[:, None] for c in TWOTOWER_CONTINUOUS]
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
