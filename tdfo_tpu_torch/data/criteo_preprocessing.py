"""Criteo-style CTR ETL — port of ``tdfo_tpu/data/criteo_preprocessing.py``.

The same input and seed give byte-identical parquet shards and
``size_map.json``.  Not ported yet: the planner's ``table_stats.json``
artifact (``ROADMAP.md`` Queue A item 14; this ETL writes none) and the
hot/cold ``hot_ids.json`` artifact (``hot_vocab > 0`` raises
``NotImplementedError``, item 13).  The reference's docstring follows.

The Criteo display-ads format (``label \\t 13 ints \\t 26 hex categoricals``
per line, TSV, no header — the Kaggle/Terabyte layout) lands in the SAME
on-disk contract the rest of the framework consumes: shuffled parquet shards
under ``data_dir/parquet`` plus ``size_map.json`` — so the generic-schema
DLRM trainer (``Config.categorical_features``) runs on it unchanged.

Transforms (standard DLRM recipe):
  * integer features: missing -> 0, clipped at 0, ``log1p``, then min-max to
    [0, 1] with GLOBAL min/max (mirrors the Goodreads ETL's continuous
    handling, ``jax-flax/preprocessing.py:110-128`` semantics);
  * categorical features: frequency-thresholded vocab (values seen >=
    ``min_freq`` times get ids 1.. by descending frequency; everything else
    — incl. missing — folds into the out-of-vocab id 0), the standard
    Criteo-DLRM vocabulary construction;
  * split: the ROW-ORDERED tail ``eval_fraction`` becomes eval (Criteo rows
    are time-ordered; the reference's per-user leave-tail split has no
    meaning here).

Two streaming passes over the TSV (stats+vocab, then transform+write), so
memory stays O(vocab), not O(rows).
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pandas as pd

__all__ = [
    "CRITEO_CONTINUOUS",
    "CRITEO_CATEGORICAL",
    "run_criteo_preprocessing",
]

N_CONT, N_CAT = 13, 26
CRITEO_CONTINUOUS = tuple(f"cont_{i}" for i in range(N_CONT))
CRITEO_CATEGORICAL = tuple(f"cat_{i}" for i in range(N_CAT))
_COLUMNS = ("label", *CRITEO_CONTINUOUS, *CRITEO_CATEGORICAL)
FILE_NUM = 8


def _chunks(path: Path, chunksize: int):
    return pd.read_csv(
        path, sep="\t", header=None, names=_COLUMNS,
        dtype={c: "Float64" for c in CRITEO_CONTINUOUS}
        | {c: "string" for c in CRITEO_CATEGORICAL} | {"label": np.int8},
        chunksize=chunksize,
    )


def run_criteo_preprocessing(
    data_dir: str | Path,
    *,
    source: str = "train.txt",
    min_freq: int = 4,
    eval_fraction: float = 0.1,
    file_num: int = FILE_NUM,
    seed: int = 42,
    chunksize: int = 500_000,
    hot_vocab: int = 0,
) -> dict[str, int]:
    """TSV -> parquet shards + size_map.json.  Returns the size map.
    ``hot_vocab > 0`` (the hot/cold artifact) is not ported yet."""
    if hot_vocab > 0:
        raise NotImplementedError(
            "preprocess-criteo with hot_vocab > 0 (the hot/cold hot_ids.json "
            "artifact) is not ported yet (ROADMAP.md Queue A item 13)")
    data_dir = Path(data_dir)
    src = data_dir / source

    # ---- pass 1: row count, per-column min/max of log1p, vocab counts ----
    n_rows = 0
    lo = np.full(N_CONT, np.inf)
    hi = np.full(N_CONT, -np.inf)
    counts: list[Counter] = [Counter() for _ in range(N_CAT)]
    for chunk in _chunks(src, chunksize):
        n_rows += len(chunk)
        for i, c in enumerate(CRITEO_CONTINUOUS):
            v = np.log1p(chunk[c].fillna(0).clip(lower=0).to_numpy(np.float64))
            if len(v):
                lo[i] = min(lo[i], float(v.min()))
                hi[i] = max(hi[i], float(v.max()))
        for i, c in enumerate(CRITEO_CATEGORICAL):
            counts[i].update(chunk[c].dropna())
    if n_rows == 0:
        raise ValueError(f"no rows in {src}")

    vocab_maps: list[dict[str, int]] = []
    size_map: dict[str, int] = {}
    for i, c in enumerate(CRITEO_CATEGORICAL):
        kept = [v for v, n in counts[i].most_common() if n >= min_freq]
        vocab_maps.append({v: j + 1 for j, v in enumerate(kept)})  # 0 = OOV
        size_map[c] = len(kept) + 1
    with open(data_dir / "size_map.json", "w") as f:
        json.dump(size_map, f, indent=4)

    # ---- pass 2: transform, split by time order, STREAM to shards --------
    # Rows append to open parquet writers as they stream past — no
    # transformed copy of the dataset ever exists in memory (the property
    # that makes Criteo-Terabyte-scale runs possible).  Train rows land on a
    # uniformly random shard, so each shard is a random SUBSET in time order;
    # the loader's file-order permutation + shuffle buffer finish the
    # randomisation at read time (vs the Goodreads ETL, which is small
    # enough to pre-shuffle whole shards in memory).
    import pyarrow as pa
    import pyarrow.parquet as pq

    n_eval = int(n_rows * eval_fraction)
    if n_eval == 0 or n_eval == n_rows:
        raise ValueError(
            f"degenerate split: {n_rows} rows at eval_fraction="
            f"{eval_fraction} leaves {'no eval' if n_eval == 0 else 'no train'} "
            "rows — provide more data or adjust eval_fraction"
        )
    split_at = n_rows - n_eval
    span = np.where(hi > lo, hi - lo, 1.0)
    write_dir = data_dir / "parquet"
    write_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    writers: dict[tuple[str, int], pq.ParquetWriter] = {}

    def append(prefix: str, shard: int, df: pd.DataFrame) -> None:
        tbl = pa.Table.from_pandas(df, preserve_index=False)
        key = (prefix, shard)
        if key not in writers:
            writers[key] = pq.ParquetWriter(
                write_dir / f"{prefix}_part_{shard}.parquet", tbl.schema
            )
        writers[key].write_table(tbl)

    seen = 0
    try:
        for chunk in _chunks(src, chunksize):
            out = pd.DataFrame(index=chunk.index)
            out["label"] = chunk["label"].to_numpy(np.int8)
            for i, c in enumerate(CRITEO_CONTINUOUS):
                v = np.log1p(
                    chunk[c].fillna(0).clip(lower=0).to_numpy(np.float64))
                out[c] = ((v - lo[i]) / span[i]).astype(np.float32)
            for i, c in enumerate(CRITEO_CATEGORICAL):
                out[c] = (
                    chunk[c].map(vocab_maps[i]).fillna(0).to_numpy(np.int32)
                )
            cut = max(0, min(len(out), split_at - seen))
            if cut:
                train = out.iloc[:cut]
                shard_of = rng.integers(0, file_num, len(train))
                for s in np.unique(shard_of):
                    append("train", int(s), train.iloc[shard_of == s])
            if cut < len(out):
                ev = out.iloc[cut:]
                # time-ordered eval rows round-robin over shards by chunk
                append("eval", (seen + cut) // chunksize % file_num, ev)
            seen += len(out)
    finally:
        for w in writers.values():
            w.close()
    return size_map
