"""DLRM-style CTR model, DMP regime — port of ``tdfo_tpu/models/dlrm.py``
(``DLRMBackbone``, ``generic_embedding_specs``).

The standard DLRM architecture over already-gathered embedding vectors: a
bottom MLP over the continuous columns projected to ``embed_dim`` (the
(F+1)-th vector), pairwise dot products between all vectors taken as the
upper triangle of one batched ``[B, F, D] x [B, F, D]`` contraction in
``np.triu_indices(f, k=1)`` order, then a top MLP over ``[bottom,
interactions]`` to one logit per row.  A schema without continuous columns
interacts the embeddings alone.  The tables live in a
:class:`~tdfo_tpu_torch.parallel.embedding.ShardedEmbeddingCollection`.
f32 compute only (``mixed_precision`` is not ported yet, ``ROADMAP.md``
Queue A item 13).

Module names are the reference's (``bottom_{i}``, ``bottom_out``,
``top_{i}``, ``top_out``), so ``interop.backbone_params_from_flax`` loads a
flax tree with ``strict=True``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from tdfo_tpu_torch.models.twotower import (
    FEATURE_TO_INPUT,
    TWOTOWER_CATEGORICAL,
    TWOTOWER_CONTINUOUS,
)

__all__ = ["DLRMBackbone", "generic_embedding_specs"]

# default schema: the Goodreads CTR columns (TwoTower parity data)
_DEFAULT_CAT_COLUMNS = tuple(FEATURE_TO_INPUT[f] for f in TWOTOWER_CATEGORICAL)


def generic_embedding_specs(size_map: Mapping[str, int],
                            columns: tuple[str, ...], embed_dim: int,
                            sharding: str = "row",
                            fused_threshold: int | None = 16384):
    """One table ``{col}_embed`` per categorical column (custom-schema CTR:
    e.g. the 26 Criteo tables); init and fusion policy live in
    ``make_embedding_specs``."""
    from tdfo_tpu_torch.parallel.embedding import make_embedding_specs

    return make_embedding_specs(
        size_map, [(col, f"{col}_embed", col) for col in columns],
        embed_dim, sharding, fused_threshold)


def _dense(in_dim: int, out_dim: int, generator) -> nn.Linear:
    """flax ``Dense`` defaults: glorot-uniform weight, zero bias."""
    lin = nn.Linear(in_dim, out_dim)
    nn.init.xavier_uniform_(lin.weight, generator=generator)
    nn.init.zeros_(lin.bias)
    return lin


class DLRMBackbone(nn.Module):
    """Bottom MLP -> pairwise dot interactions -> top MLP -> ``[B]``
    logits.  ``forward(embs, batch)``: ``embs`` maps each categorical input
    column to its ``[B, D]`` vectors; ``batch`` supplies the continuous
    columns."""

    def __init__(self, embed_dim: int, bottom_dims: tuple[int, ...] = (64,),
                 top_dims: tuple[int, ...] = (128, 64),
                 cat_columns: tuple[str, ...] = _DEFAULT_CAT_COLUMNS,
                 cont_columns: tuple[str, ...] = TWOTOWER_CONTINUOUS,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cat_columns = tuple(cat_columns)
        self.cont_columns = tuple(cont_columns)
        self.bottom_dims = tuple(bottom_dims)
        self.top_dims = tuple(top_dims)
        f = len(self.cat_columns)
        width = len(self.cont_columns)
        if self.cont_columns:
            for i, w in enumerate(self.bottom_dims):
                setattr(self, f"bottom_{i}", _dense(width, w, generator))
                width = w
            self.bottom_out = _dense(width, embed_dim, generator)
            f += 1
        iu, ju = np.triu_indices(f, k=1)
        self.register_buffer("_iu", torch.from_numpy(iu.astype(np.int64)),
                             persistent=False)
        self.register_buffer("_ju", torch.from_numpy(ju.astype(np.int64)),
                             persistent=False)
        width = len(iu) + (embed_dim if self.cont_columns else 0)
        for i, w in enumerate(self.top_dims):
            setattr(self, f"top_{i}", _dense(width, w, generator))
            width = w
        self.top_out = _dense(width, 1, generator)

    def forward(self, embs: Mapping[str, torch.Tensor],
                batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        stack = [embs[c].to(torch.float32) for c in self.cat_columns]
        if self.cont_columns:
            x = torch.stack([batch[c].to(torch.float32)
                             for c in self.cont_columns], dim=-1)  # [B, C]
            for i in range(len(self.bottom_dims)):
                x = torch.relu(getattr(self, f"bottom_{i}")(x))
            x = torch.relu(self.bottom_out(x))  # [B, D]
            stack.append(x)
        vecs = torch.stack(stack, dim=1)  # [B, F(+1), D]
        inter = torch.bmm(vecs, vecs.transpose(1, 2))  # [B, F, F]
        flat = inter[:, self._iu, self._ju]  # upper-triangle pairs
        top = torch.cat([x, flat], dim=-1) if self.cont_columns else flat
        for i in range(len(self.top_dims)):
            top = torch.relu(getattr(self, f"top_{i}")(top))
        return self.top_out(top)[:, 0]
