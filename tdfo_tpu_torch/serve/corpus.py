"""Candidate corpus build — port of ``tdfo_tpu/serve/corpus.py``
(``Corpus``, ``synthetic_item_features``, ``build_corpus``).

The item tower sweeps the catalogue in ``corpus_batch`` chunks (the last
chunk zero-padded, so every chunk has one shape) through the scorer's
``item_embed``, and the ``[N_items, D]`` corpus is stored as ``float32``,
``bfloat16`` (a round-to-nearest cast) or ``int8`` (round-to-nearest onto
the rowwise grid, ``ops/quant.py::quantize_rows`` without a key, with its
f32 ``[N, 2]`` (scale, offset) sidecar; ``divide=True``: the reference
quantizes its corpora outside ``jax.jit``, with a true division by 255).  On one device the corpus needs
no shard padding; ``ids`` still mark padding rows -1, which retrieval never
returns (``load_corpus`` and ``item_corpus`` build the same ``Corpus``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from tdfo_tpu_torch.models.twotower import (
    FEATURE_TO_INPUT,
    TWOTOWER_CONTINUOUS,
    TWOTOWER_ITEM_CATEGORICAL,
)
from tdfo_tpu_torch.ops.quant import STORAGE_DTYPES, quantize_rows
from tdfo_tpu_torch.serve.scoring import Scorer, refuse_mesh

__all__ = ["Corpus", "build_corpus", "store_corpus", "synthetic_item_features"]

# item-side input columns of the TwoTower catalogue, id column first
ITEM_COLUMNS = tuple(FEATURE_TO_INPUT[f] for f in TWOTOWER_ITEM_CATEGORICAL)


@dataclass(frozen=True)
class Corpus:
    """``vectors[i]`` scores item ``ids[i]``; rows with ``ids[i] == -1`` are
    padding (never returned).  ``qscale`` is the f32 ``[N, 2]`` (scale,
    offset) sidecar of an int8 corpus (row = ``code * scale + offset``),
    ``None`` for float corpora.  Tensors live on one device."""

    vectors: torch.Tensor  # [N_pad, D]
    ids: torch.Tensor  # [N_pad] int32; -1 = padding
    n_items: int
    qscale: torch.Tensor | None = None


def synthetic_item_features(size_map: Mapping[str, int], n_items: int,
                            seed: int = 0) -> dict[str, np.ndarray]:
    """Deterministic per-item catalogue features (the reference's draws from
    the same seed): categorical attributes within each vocab, continuous
    columns in [0, 1)."""
    rng = np.random.default_rng(seed)
    feats: dict[str, np.ndarray] = {"item_id": np.arange(n_items, dtype=np.int32)}
    for feat in TWOTOWER_ITEM_CATEGORICAL[1:]:  # skip the id column itself
        col = FEATURE_TO_INPUT[feat]
        feats[col] = rng.integers(0, int(size_map[feat]), size=n_items, dtype=np.int32)
    for col in TWOTOWER_CONTINUOUS:
        feats[col] = rng.random(n_items, dtype=np.float32)
    return feats


def store_corpus(vectors: torch.Tensor, ids: torch.Tensor, n_items: int,
                 dtype: str) -> Corpus:
    """f32 rows -> a :class:`Corpus` at storage ``dtype``."""
    if dtype not in STORAGE_DTYPES:
        raise ValueError(f"corpus dtype {dtype!r} not in {STORAGE_DTYPES}")
    qscale = None
    if dtype == "bfloat16":
        vectors = vectors.to(torch.bfloat16)
    elif dtype == "int8":
        vectors, qscale = quantize_rows(vectors, divide=True)
    return Corpus(vectors=vectors, ids=ids, n_items=n_items, qscale=qscale)


def build_corpus(scorer: Scorer, item_features: Mapping[str, np.ndarray], *,
                 corpus_batch: int = 8192, mesh=None,
                 dtype: str = "float32") -> Corpus:
    """Sweep the item tower over ``item_features`` (every item-side input
    column as an aligned ``[N]`` array; ``item_id`` defaults to
    ``arange(N)``) -> :class:`Corpus` on the scorer's device, stored at
    ``dtype`` (``float32`` exact, ``bfloat16``, or ``int8`` with its
    sidecar).  ``mesh`` (a sharded corpus) refuses: item 12b."""
    refuse_mesh(mesh)
    if dtype not in STORAGE_DTYPES:
        raise ValueError(f"corpus dtype {dtype!r} not in {STORAGE_DTYPES}")
    feats = {k: np.asarray(v) for k, v in item_features.items()}
    n_items = len(next(iter(feats.values())))
    feats.setdefault("item_id", np.arange(n_items, dtype=np.int32))
    for k, v in feats.items():
        if len(v) != n_items:
            raise ValueError(
                f"item_features column {k!r} has {len(v)} rows, expected "
                f"{n_items} (all columns must align)")
    missing = [c for c in (*ITEM_COLUMNS, *scorer.cont_columns) if c not in feats]
    if missing:
        raise ValueError(f"item_features missing columns {missing}")

    chunks = []
    for start in range(0, n_items, corpus_batch):
        stop = min(start + corpus_batch, n_items)
        pad = corpus_batch - (stop - start)
        batch = {k: np.pad(v[start:stop], [(0, pad)]) for k, v in feats.items()}
        vecs = scorer.item_embed(batch)
        chunks.append(vecs[:stop - start] if pad else vecs)
    vectors = torch.cat(chunks, dim=0).to(torch.float32)
    ids = torch.arange(n_items, dtype=torch.int32, device=vectors.device)
    return store_corpus(vectors, ids, n_items, dtype)
