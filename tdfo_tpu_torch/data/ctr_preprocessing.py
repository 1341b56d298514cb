"""Goodreads CTR ETL — TwoTower features, parquet shards, size_map contract.

Port of ``tdfo_tpu/data/ctr_preprocessing.py``: the same seed gives
byte-identical parquet shards and ``size_map.json``.  Not ported yet: the
planner's ``table_stats.json`` artifact, the hot/cold ``hot_ids.json``
artifact (``hot_vocab > 0``) and ``write_format = "tfrecord"``; the latter
two raise ``NotImplementedError`` (``ROADMAP.md`` Queue A items 13, 14, 16).
The reference's docstring follows.

Capability parity with ``jax-flax/preprocessing.py`` (and its twin
``tensorflow2/preprocessing.py``), re-implemented on pandas/pyarrow (this
image carries no polars) with vectorised groupby/merge instead of
row-level apply:

  * interactions: keep users with 10..250 interactions, label = rating>=4,
    per-user sorted item lists (``jax-flax/preprocessing.py:40-71``).
  * book features: 5 categoricals (empty -> "unknown", sorted-unique vocab ->
    contiguous ids; ``:131-144``), 2 continuous (empty/outlier -> median,
    min-max normalise; ``:110-128``), publication year -> decade bucket
    (``:74-107`` — note the reference's inclusive ``is_between`` chains put
    exact decade boundaries (e.g. 1910) in the EARLIER decade; preserved).
  * split: per user, first ceil(0.8*n) sorted items -> train, rest -> eval
    (``:212-237``).
  * output: 8 parquet shards per split, train rows shuffled with seed 42
    (``:240-270``), plus ``size_map.json`` (``:273-275``) — the
    preprocessing -> training contract.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pandas as pd

from tdfo_tpu_torch.data.shards import shard_ranges, write_df_part

__all__ = ["run_ctr_preprocessing", "FINAL_COLUMNS"]

SPLIT_RATIO = 0.8
FILE_NUM = 8
MAX_CONTINUOUS = 2000.0  # reference outlier bound for avg_rating / num_pages

FINAL_COLUMNS = [
    "user_id", "item_id", "language", "is_ebook", "format", "publisher",
    "pub_decade", "avg_rating", "num_pages", "is_read", "is_reviewed", "label",
]

CATEGORY_COLS = ["language", "is_ebook", "format", "publisher", "pub_decade"]
CONTINUOUS_COLS = ["avg_rating", "num_pages"]


def read_interactions(data_dir: Path) -> pd.DataFrame:
    """Users with 10..250 interactions; label = rating>=4; items sorted per user."""
    df = pd.read_csv(
        data_dir / "goodreads_interactions.csv",
        dtype={"user_id": np.int32, "book_id": np.int32, "is_read": np.int8,
               "rating": np.int8, "is_reviewed": np.int8},
    )
    counts = df.groupby("user_id")["book_id"].transform("size")
    df = df[(counts >= 10) & (counts <= 250)]
    df = df.assign(label=(df["rating"] >= 4).astype(np.int8)).drop(columns=["rating"])
    return df.sort_values(["user_id", "book_id"], kind="stable").reset_index(drop=True)


def year_to_decade(years: pd.Series) -> pd.Series:
    """Publication year string -> decade label.

    Inclusive-boundary semantics preserved from the reference's chained
    ``is_between``: a year landing exactly on a boundary (1910, 1920, ...)
    belongs to the earlier decade; range covered is [1900, 2030]."""
    y = pd.to_numeric(years, errors="coerce")
    decade_start = np.where(y <= 1900, -1, ((y - 1) // 10 * 10))
    decade_start = np.where(y == 1900, 1900, decade_start)
    valid = (y >= 1900) & (y <= 2030) & ~np.isnan(y)
    labels = np.where(valid, np.char.add(
        np.nan_to_num(decade_start, nan=0).astype(np.int64).astype(str), "s"
    ), "unknown")
    return pd.Series(labels, index=years.index, dtype=object)


def build_vocab(col: pd.Series) -> dict[str, int]:
    """Empty -> "unknown"; sorted unique values -> contiguous ids from 0."""
    vals = col.astype(object).fillna("").replace("", "unknown")
    uniq = sorted(set(map(str, vals)))
    return {v: i for i, v in enumerate(uniq)}


def encode_categorical(col: pd.Series, vocab: dict[str, int]) -> np.ndarray:
    vals = col.astype(object).fillna("").replace("", "unknown").astype(str)
    return vals.map(vocab).to_numpy(dtype=np.int32)


def normalize_continuous(col: pd.Series) -> np.ndarray:
    """Empty -> median, > MAX_CONTINUOUS -> median, then min-max."""
    x = pd.to_numeric(col.astype(object).replace("", np.nan), errors="coerce")
    valid = x[(~x.isna()) & (x <= MAX_CONTINUOUS)]
    lo, hi = float(valid.min()), float(valid.max())
    med = round(float(valid.median()), 4)
    x = x.fillna(med)
    x = x.where(x <= MAX_CONTINUOUS, med)
    return ((x - lo) / (hi - lo)).to_numpy(dtype=np.float32)


def get_book_features(data_dir: Path) -> tuple[pd.DataFrame, dict[str, int]]:
    """Book feature table keyed by contiguous book_id, plus the size_map."""
    size_map: dict[str, int] = {}
    user_map = pd.read_csv(data_dir / "user_id_map.csv")
    size_map["user"] = int(len(user_map))
    book_map = pd.read_csv(data_dir / "book_id_map.csv")
    book_map.columns = ["book_id", "book_original_id"]
    book_map["book_original_id"] = book_map["book_original_id"].astype(str)
    size_map["item"] = int(len(book_map))

    # STREAM the ndjson in bounded chunks, keeping only the feature columns
    # (the reference streams this file too: polars collect(streaming=True),
    # jax-flax/preprocessing.py:53 — a full read of the 2 GB books dump
    # would spike peak RSS by the whole raw payload)
    keep = ["book_id", "language_code", "is_ebook", "average_rating",
            "format", "publisher", "num_pages", "publication_year"]
    chunks = []
    with pd.read_json(data_dir / "goodreads_books.json", lines=True,
                      dtype=False, chunksize=100_000) as reader:
        for chunk in reader:
            chunks.append(chunk[[c for c in keep if c in chunk.columns]])
    books = pd.concat(chunks, ignore_index=True)
    books = books.rename(columns={
        "book_id": "book_original_id", "language_code": "language",
        "average_rating": "avg_rating", "publication_year": "pub_year",
    })
    books["book_original_id"] = books["book_original_id"].astype(str)
    books["pub_decade"] = year_to_decade(books["pub_year"])

    out = pd.DataFrame({"book_original_id": books["book_original_id"]})
    for col in CATEGORY_COLS:
        vocab = build_vocab(books[col])
        out[col] = encode_categorical(books[col], vocab)
        size_map[col] = len(vocab)
    for col in CONTINUOUS_COLS:
        out[col] = normalize_continuous(books[col])

    feats = book_map.merge(out, on="book_original_id", how="left").drop(
        columns=["book_original_id"]
    )
    assert not feats.isna().any().any(), "book feature join left nulls"
    return feats, size_map


def split_interactions(df: pd.DataFrame, is_train: bool) -> pd.DataFrame:
    """Per user: first ceil(0.8*n) sorted items train, the rest eval."""
    rank = df.groupby("user_id").cumcount()
    n = df.groupby("user_id")["book_id"].transform("size")
    cut = np.ceil(n * SPLIT_RATIO).astype(np.int64)
    keep = rank < cut if is_train else rank >= cut
    return df.loc[keep, ["user_id", "book_id"]]


def _join_split_part(part: pd.DataFrame, split_key: pd.MultiIndex,
                     book_features: pd.DataFrame) -> pd.DataFrame:
    """Restrict interaction rows to the split's (user, item) pairs and join
    book features into the final training schema (shared by both formats)."""
    mask = pd.MultiIndex.from_frame(part[["user_id", "book_id"]]).isin(split_key)
    part = part[mask]
    return part.merge(book_features, on="book_id", how="left").rename(
        columns={"book_id": "item_id"}
    )[FINAL_COLUMNS]


def write_parquet_shards(
    data_dir: Path,
    split_pairs: pd.DataFrame,
    interactions: pd.DataFrame,
    book_features: pd.DataFrame,
    prefix: str,
    *,
    file_num: int = FILE_NUM,
    seed: int = 42,
) -> list[Path]:
    """FILE_NUM shards: slice the interaction table, restrict to the split's
    (user, item) pairs, join book features; train rows shuffled."""
    write_dir = data_dir / "parquet"
    write_dir.mkdir(exist_ok=True)
    key = pd.MultiIndex.from_frame(split_pairs)
    paths = []
    for i, start, end in shard_ranges(len(interactions), file_num):
        part = _join_split_part(interactions.iloc[start:end], key, book_features)
        paths.append(write_df_part(part, write_dir, prefix, i,
                                   shuffle=prefix == "train", seed=seed))
    return paths


def run_ctr_preprocessing(data_dir: str | Path, *, file_num: int = FILE_NUM,
                          seed: int = 42,
                          write_format: str = "parquet",
                          hot_vocab: int = 0,
                          hot_fraction: float = 0.9) -> dict[str, int]:
    """Full ETL: raw goodreads files -> parquet shards + size_map.json.
    ``hot_vocab > 0`` and ``write_format = "tfrecord"`` are refused until
    their slices land (see the module docstring)."""
    if hot_vocab > 0:
        raise NotImplementedError(
            "hot/cold id artifacts (hot_vocab > 0) are not ported yet "
            "(ROADMAP.md Queue A item 13)")
    if write_format == "tfrecord":
        raise NotImplementedError(
            "write_format = 'tfrecord' is not ported yet (ROADMAP.md Queue A "
            "item 16)")
    data_dir = Path(data_dir)
    book_features, size_map = get_book_features(data_dir)
    with open(data_dir / "size_map.json", "w") as f:
        json.dump(size_map, f, indent=4)

    interactions = read_interactions(data_dir)
    # ids index Embed tables sized by the id maps; an out-of-range id would
    # silently gather NaN (jnp.take fill mode) at train time — fail here.
    if interactions["user_id"].max() >= size_map["user"] or interactions["user_id"].min() < 0:
        raise ValueError("interaction user_id outside [0, n_users) of user_id_map")
    if interactions["book_id"].max() >= size_map["item"] or interactions["book_id"].min() < 0:
        raise ValueError("interaction book_id outside [0, n_items) of book_id_map")
    for prefix, is_train in (("train", True), ("eval", False)):
        pairs = split_interactions(interactions, is_train)
        if write_format == "parquet":
            write_parquet_shards(
                data_dir, pairs, interactions, book_features, prefix,
                file_num=file_num, seed=seed,
            )
        else:
            raise ValueError(f"unknown write_format {write_format!r}")
    return size_map
