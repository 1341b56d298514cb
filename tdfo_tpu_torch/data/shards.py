"""Shared parquet shard-writing primitives for both ETLs.

Port of ``tdfo_tpu/data/shards.py`` (pandas only, unchanged).

One policy for shard slicing, train-shuffle, and file naming
(``{prefix}_part_{i}.parquet``, 1-indexed — the contract the loaders and the
reference's readers share: ``jax-flax/preprocessing.py:240-270``,
``torchrec/preprocessing.py:318-334``).
"""

from __future__ import annotations

import math
from pathlib import Path

import pandas as pd

__all__ = ["shard_ranges", "write_df_part"]


def shard_ranges(n_rows: int, file_num: int):
    """Yield (part_index_1based, start, end) row ranges."""
    file_unit = math.ceil(max(n_rows, 1) / file_num)
    for i, offset in enumerate(range(0, n_rows, file_unit), start=1):
        yield i, offset, min(offset + file_unit, n_rows)


def write_df_part(
    part: pd.DataFrame,
    write_dir: Path,
    prefix: str,
    index: int,
    *,
    shuffle: bool,
    seed: int,
) -> Path:
    """Write one shard; train shards are row-shuffled with the fixed seed."""
    if shuffle:
        part = part.sample(frac=1.0, random_state=seed)
    path = write_dir / f"{prefix}_part_{index}.parquet"
    part.to_parquet(path, index=False)
    return path
