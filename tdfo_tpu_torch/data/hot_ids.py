"""Hot-id remap artifacts for frequency-partitioned (hot/cold) embeddings.

A copy of ``tdfo_tpu/data/hot_ids.py`` (numpy only): both packages write
and read the same ``hot_ids.json`` and compute the same digests.  In this
package the hot head is updated by ``SparseOptimizer.dense_update`` (a
segment sum and a dense step) where the reference text below says one-hot
MXU contractions.

Recsys lookup traffic is power-law: a tiny head of ids absorbs most of the
lookup mass (the observation behind fbgemm's ``MANAGED_CACHING`` placement
and the FAE "hot embeddings fit in fast memory" design).  The preprocessing
passes already count value frequencies, so they can emit, per table, the
smallest frequency-ranked id prefix covering ``hot_fraction`` of the lookup
mass (capped at ``hot_vocab`` ids) as a ``hot_ids.json`` artifact next to
``size_map.json``.  At build time ``ShardedEmbeddingCollection`` splits
every listed table into a small contiguous HOT head (replicated, updated
scatter-free via one-hot MXU contractions) and the residual COLD table
(row-sharded, updated via the existing dedupe + row-scatter path) — see
``parallel/embedding.py``.

The artifact is a MODEL-STATE compatibility surface: a checkpoint written
under one hot set pairs every hot row with a specific id, so resuming under
a different artifact would silently scramble the head.  ``hot_ids_digest``
fingerprints the artifact for the checkpoint ``stamps`` sidecar
(``train/checkpoint.py``), which refuses such resumes loudly.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Mapping

import numpy as np

__all__ = [
    "FORMAT_VERSION",
    "hot_ids_from_counts",
    "write_hot_ids",
    "load_hot_ids",
    "hot_ids_digest",
]

# Artifact schema version; bump on incompatible layout changes so a loader
# never silently misreads an old file.
FORMAT_VERSION = 1

_FILENAME = "hot_ids.json"


def hot_ids_from_counts(
    counts: np.ndarray, *, hot_vocab: int, hot_fraction: float = 0.9
) -> np.ndarray:
    """The hot-id set of one table from its per-id lookup counts
    (``counts[i]`` = lookups of id ``i``): the SMALLEST count-ranked prefix
    whose mass reaches ``hot_fraction`` of the total, capped at
    ``hot_vocab`` ids.  Ties break toward lower ids (stable argsort on
    negated counts), so ETLs that already assign ids by descending
    frequency (the Criteo recipe) produce contiguous ``[0, K)`` prefixes —
    which the collection remaps with a compare instead of a searchsorted.
    Returns the hot ids SORTED ascending (int32).  A table whose whole
    vocab fits under the cap is fully hot (every id in the set) regardless
    of mass — its cold side would be empty anyway.
    """
    counts = np.asarray(counts)
    v = counts.shape[0]
    if hot_vocab <= 0:
        raise ValueError(f"hot_vocab must be positive, got {hot_vocab}")
    if v <= hot_vocab:
        return np.arange(v, dtype=np.int32)
    order = np.argsort(-counts, kind="stable")
    total = float(counts.sum())
    if total <= 0:
        k = hot_vocab  # no mass observed: take the cap (arbitrary but valid)
    else:
        mass = np.cumsum(counts[order]) / total
        k = int(np.searchsorted(mass, hot_fraction) + 1)
        k = min(k, hot_vocab)
    return np.sort(order[:k]).astype(np.int32)


def write_hot_ids(
    data_dir: str | Path,
    per_table: Mapping[str, np.ndarray],
    *,
    hot_vocab: int,
    hot_fraction: float,
    coverage: Mapping[str, float] | None = None,
) -> Path:
    """Persist the artifact next to the parquet shards / size_map.json.
    ``per_table`` keys are the categorical COLUMN names (the feature names
    the trainer's embedding specs use); values are sorted id arrays from
    :func:`hot_ids_from_counts`.  ``coverage`` optionally records each
    table's achieved lookup-mass fraction (diagnostics only)."""
    data_dir = Path(data_dir)
    payload = {
        "format_version": FORMAT_VERSION,
        "hot_vocab": int(hot_vocab),
        "hot_fraction": float(hot_fraction),
        "tables": {
            name: np.asarray(ids, dtype=np.int64).tolist()
            for name, ids in per_table.items()
        },
    }
    if coverage is not None:
        payload["coverage"] = {k: float(c) for k, c in coverage.items()}
    path = data_dir / _FILENAME
    path.write_text(json.dumps(payload))
    return path


def load_hot_ids(data_dir: str | Path) -> dict[str, np.ndarray] | None:
    """Read the artifact back as ``{column: sorted int32 ids}``; ``None``
    when ``data_dir`` carries no artifact (hot/cold then cannot build —
    the trainer raises with re-run-preprocessing guidance)."""
    path = Path(data_dir) / _FILENAME
    if not path.exists():
        return None
    payload = json.loads(path.read_text())
    version = payload.get("format_version")
    if version != FORMAT_VERSION:
        raise ValueError(
            f"{path} has hot-id artifact format_version {version!r}, this "
            f"build reads {FORMAT_VERSION}.  Re-run preprocessing to "
            "regenerate the artifact."
        )
    out = {}
    for name, ids in payload["tables"].items():
        arr = np.asarray(ids, dtype=np.int32)
        if arr.ndim != 1 or (arr.size and (np.any(np.diff(arr) <= 0)
                                           or arr[0] < 0)):
            raise ValueError(
                f"{path}: table {name!r} hot ids must be sorted, unique and "
                "non-negative — the file is corrupt; re-run preprocessing."
            )
        out[name] = arr
    return out


def hot_ids_digest(per_table: Mapping[str, np.ndarray]) -> dict[str, str]:
    """Per-table fingerprint of the hot sets for the checkpoint ``stamps``
    sidecar: sha256 over the sorted int64 id bytes, truncated to 16 hex
    chars (collision-safe at artifact scale, short enough to read in an
    error message)."""
    return {
        name: hashlib.sha256(
            np.asarray(ids, dtype=np.int64).tobytes()
        ).hexdigest()[:16]
        for name, ids in sorted(per_table.items())
    }
