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

Under a ``mesh`` the corpus shards over its ``data`` axis (S ranks, each
one process): the catalogue pads to ``N_pad = ceil(N / S) * S`` rows with
zero vectors of id -1, BEFORE bf16 / int8 storage (the reference's order;
the rowwise grid is per row, so a real row's bits do not depend on the
padding), and rank ``r`` keeps rows ``[r * N_pad / S, (r + 1) * N_pad /
S)``, sweeping only those through the item tower.  At S = 1 the corpus is
the single-device one.
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
from tdfo_tpu_torch.core.mesh import DATA_AXIS, axis_index, axis_size
from tdfo_tpu_torch.ops.quant import STORAGE_DTYPES, quantize_rows
from tdfo_tpu_torch.serve.scoring import Scorer

__all__ = ["Corpus", "build_corpus", "corpus_from_rows", "pad_shard",
           "shard_rows", "store_corpus", "synthetic_item_features"]

# item-side input columns of the TwoTower catalogue, id column first
ITEM_COLUMNS = tuple(FEATURE_TO_INPUT[f] for f in TWOTOWER_ITEM_CATEGORICAL)


@dataclass(frozen=True)
class Corpus:
    """``vectors[i]`` scores item ``ids[i]``; rows with ``ids[i] == -1`` are
    padding (never returned).  ``qscale`` is the f32 ``[N, 2]`` (scale,
    offset) sidecar of an int8 corpus (row = ``code * scale + offset``),
    ``None`` for float corpora.  Tensors live on one device.  A sharded
    corpus (the module note) holds shard ``shard`` of ``n_shards``: its
    ``rows_per_shard`` rows start at global position ``shard *
    rows_per_shard``; ``n_items`` is always the whole catalogue's."""

    vectors: torch.Tensor  # [N_pad / S, D]
    ids: torch.Tensor  # [N_pad / S] int32; -1 = padding
    n_items: int
    qscale: torch.Tensor | None = None
    shard: int = 0
    n_shards: int = 1

    @property
    def rows_per_shard(self) -> int:
        return self.vectors.shape[0]


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


def shard_rows(n_items: int, mesh) -> tuple[int, int, int, int]:
    """``(shard, n_shards, lo, hi)``: this rank's shard of an ``n_items``
    corpus over ``mesh``'s data axis and the catalogue rows ``[lo, hi)`` it
    holds (``(0, 1, 0, n_items)`` without a mesh); its ``ceil(n_items /
    n_shards)`` rows end in padding past ``hi``."""
    n_shards = axis_size(mesh, DATA_AXIS)
    shard, rps = axis_index(mesh, DATA_AXIS), -(-n_items // n_shards)
    return shard, n_shards, min(shard * rps, n_items), min((shard + 1) * rps, n_items)


def pad_shard(vectors: torch.Tensor, ids: torch.Tensor, n_items: int,
              n_shards: int):
    """A shard's rows padded to ``ceil(n_items / n_shards)``: zero vectors
    of id -1 (float rows, before storage)."""
    pad = -(-n_items // n_shards) - vectors.shape[0]
    return (torch.nn.functional.pad(vectors, (0, 0, 0, pad)),
            torch.nn.functional.pad(ids, (0, pad), value=-1))


def store_corpus(vectors: torch.Tensor, ids: torch.Tensor, n_items: int,
                 dtype: str, *, shard: int = 0, n_shards: int = 1) -> Corpus:
    """f32 rows (a shard's, padding included) -> a :class:`Corpus` at
    storage ``dtype``."""
    if dtype not in STORAGE_DTYPES:
        raise ValueError(f"corpus dtype {dtype!r} not in {STORAGE_DTYPES}")
    qscale = None
    if dtype == "bfloat16":
        vectors = vectors.to(torch.bfloat16)
    elif dtype == "int8":
        vectors, qscale = quantize_rows(vectors, divide=True)
    return Corpus(vectors=vectors, ids=ids, n_items=n_items, qscale=qscale,
                  shard=shard, n_shards=n_shards)


def corpus_from_rows(rows: torch.Tensor, ids: torch.Tensor, dtype: str, *,
                     mesh=None, device="cpu") -> Corpus:
    """The whole catalogue's f32 ``rows [N, D]`` and ``ids [N]`` (any
    device) -> this rank's :class:`Corpus` on ``device`` at ``dtype``,
    padded and sharded over ``mesh``'s data axis (the module note)."""
    n_items = rows.shape[0]
    shard, n_shards, lo, hi = shard_rows(n_items, mesh)
    vectors, ids = pad_shard(rows[lo:hi].to(device, torch.float32),
                             ids[lo:hi].to(device, torch.int32), n_items, n_shards)
    return store_corpus(vectors, ids, n_items, dtype, shard=shard,
                        n_shards=n_shards)


def build_corpus(scorer: Scorer, item_features: Mapping[str, np.ndarray], *,
                 corpus_batch: int = 8192, mesh=None,
                 dtype: str = "float32") -> Corpus:
    """Sweep the item tower over ``item_features`` (every item-side input
    column as an aligned ``[N]`` array; ``item_id`` defaults to
    ``arange(N)``) -> :class:`Corpus` on the scorer's device, stored at
    ``dtype`` (``float32`` exact, ``bfloat16``, or ``int8`` with its
    sidecar).  ``mesh``: this rank's shard over the data axis (the module
    note); every rank calls this."""
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

    shard, n_shards, lo, hi = shard_rows(n_items, mesh)
    chunks = []
    for start in range(lo, hi, corpus_batch):
        stop = min(start + corpus_batch, hi)
        pad = corpus_batch - (stop - start)
        batch = {k: np.pad(v[start:stop], [(0, pad)]) for k, v in feats.items()}
        vecs = scorer.item_embed(batch)
        chunks.append(vecs[:stop - start] if pad else vecs)
    dev = scorer.device
    vectors = (torch.cat(chunks, dim=0).to(torch.float32) if chunks else
               torch.zeros((0, scorer.embed_dim), dtype=torch.float32, device=dev))
    vectors, ids = pad_shard(vectors, torch.arange(lo, hi, dtype=torch.int32,
                                                   device=dev), n_items, n_shards)
    return store_corpus(vectors, ids, n_items, dtype, shard=shard,
                        n_shards=n_shards)
