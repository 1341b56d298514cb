"""Synthetic Goodreads raw files — test/demo fixture for the ETL pipeline.

Port of ``write_synthetic_goodreads`` and ``write_synthetic_criteo`` from
``tdfo_tpu/data/synthetic.py`` (numpy/pandas only, unchanged: the same seed
writes byte-identical raw files in both packages).  ``zipf_ids`` (the
reference bench's power-law batches) is not ported: nothing in the port
draws power-law ids yet.

Generates the four raw inputs the preprocessing layer consumes
(``goodreads_interactions.csv``, ``goodreads_books.json`` ndjson,
``user_id_map.csv``, ``book_id_map.csv``) with the same schema and the same
dirt the real dump has: empty strings in categoricals/continuous, years
outside [1900, 2030], ``num_pages`` outliers above 2000 — so every cleaning
branch of the ETL is exercised.  The reference has no such fixture (it has no
tests at all, SURVEY.md §4); this is part of the test pyramid it lacks.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pandas as pd

__all__ = ["write_synthetic_goodreads", "write_synthetic_criteo"]


_LANGS = ["eng", "en-US", "spa", "fre", "ger", ""]
_FORMATS = ["Paperback", "Hardcover", "ebook", "Audio CD", ""]
_PUBLISHERS = [f"publisher_{i}" for i in range(12)] + [""]


def write_synthetic_goodreads(
    data_dir: str | Path,
    *,
    n_users: int = 120,
    n_books: int = 300,
    interactions_per_user: tuple[int, int] = (5, 60),
    seed: int = 0,
    signal: float = 0.0,
) -> Path:
    """Write raw files under ``data_dir``; returns the dir.  Zipf-ish item
    popularity so popularity-weighted negative sampling has signal.

    ``signal`` in [0, 1] plants LEARNABLE structure (default 0 keeps the
    historical pure-noise fixtures byte-identical): books fall into latent
    clusters, each user has a theme cluster, themed draws are preferred
    with probability ``signal``, and ratings are biased up on theme
    matches.  The CTR label (rating >= 4) then correlates with the
    user x item embedding interaction and item sequences are
    theme-coherent — so converged eval AUC / Recall@K measurably beat the
    0.5 / popularity floors (the quality-parity evidence the reference
    establishes with real Goodreads data, torchrec/train.py:143-144,
    jax-flax/train_dp.py:219-245).
    """
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    # --- interactions: variable per-user counts, popularity-skewed items.
    # ids are 0-based contiguous, exactly like the real goodreads dump (the
    # id-map CSVs define the contiguous range; Embed tables are sized by the
    # map row count, so an id == n_users would be out of bounds). ---
    item_weights = 1.0 / np.arange(1, n_books + 1) ** 0.8
    item_weights /= item_weights.sum()
    n_clusters = 8
    book_cluster = np.arange(n_books) % n_clusters
    rows = []
    for u in range(n_users):
        k = int(rng.integers(*interactions_per_user))
        k = min(k, n_books)
        if signal > 0.0:
            theme = int(rng.integers(0, n_clusters))
            w = item_weights * np.where(
                book_cluster == theme, 1.0 + 19.0 * signal, 1.0)
            w /= w.sum()
            books = rng.choice(np.arange(n_books), size=k, replace=False, p=w)
            match = book_cluster[books] == theme
            # themed books rate high, off-theme low (plus noise): the
            # rating>=4 label becomes predictable from (user, item)
            base = np.where(match, 4.3, 1.7)
            ratings = np.clip(np.round(
                base + rng.normal(0.0, 1.2 * (1.0 - signal) + 0.6, size=k)
            ), 0, 5).astype(int)
        else:
            books = rng.choice(np.arange(n_books), size=k, replace=False,
                               p=item_weights)
            ratings = rng.integers(0, 6, size=k)
        for b, r in zip(books, ratings):
            rows.append((u, int(b), int(rng.integers(0, 2)), int(r),
                         int(rng.integers(0, 2))))
    inter = pd.DataFrame(rows, columns=["user_id", "book_id", "is_read",
                                        "rating", "is_reviewed"])
    inter.to_csv(data_dir / "goodreads_interactions.csv", index=False)

    # --- id maps (contiguous id -> original id) ---
    pd.DataFrame({
        "user_id_csv": np.arange(n_users),
        "user_id": [f"u{i:08x}" for i in range(n_users)],
    }).to_csv(data_dir / "user_id_map.csv", index=False)
    pd.DataFrame({
        "book_id_csv": np.arange(n_books),
        "book_id": [f"b{i:08x}" for i in range(n_books)],
    }).to_csv(data_dir / "book_id_map.csv", index=False)

    # --- book metadata ndjson, with dirty fields ---
    with open(data_dir / "goodreads_books.json", "w") as f:
        for i in range(n_books):
            year = int(rng.integers(1880, 2035))  # some out of decade range
            pages = int(rng.integers(20, 3000))  # some past the 2000 outlier bound
            rec = {
                "book_id": f"b{i:08x}",
                "language_code": str(rng.choice(_LANGS)),
                "is_ebook": bool(rng.integers(0, 2)),
                "average_rating": "" if rng.random() < 0.05 else f"{rng.uniform(1, 5):.2f}",
                "format": str(rng.choice(_FORMATS)),
                "publisher": str(rng.choice(_PUBLISHERS)),
                "num_pages": "" if rng.random() < 0.1 else str(pages),
                "publication_year": "" if rng.random() < 0.1 else str(year),
            }
            f.write(json.dumps(rec) + "\n")
    return data_dir


def write_synthetic_criteo(
    data_dir: str | Path,
    *,
    n_rows: int = 4000,
    seed: int = 0,
) -> Path:
    """Criteo-format ``train.txt`` fixture: label \\t 13 ints \\t 26 hex cats,
    TSV, no header, with the real dump's dirt — missing ints, missing cats,
    skewed (zipf) category popularity so the frequency-thresholded vocab
    build has both kept and OOV-folded values."""
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = []
    cat_pools = [
        [f"{rng.integers(0, 2**32):08x}" for _ in range(max(4, 3 + i * 2))]
        for i in range(26)
    ]
    for _ in range(n_rows):
        label = int(rng.random() < 0.25)
        ints = []
        for i in range(13):
            if rng.random() < 0.15:
                ints.append("")  # missing
            else:
                ints.append(str(int(rng.zipf(1.7)) - 1 + (i % 3)))
        cats = []
        for i in range(26):
            if rng.random() < 0.1:
                cats.append("")  # missing
            else:
                pool = cat_pools[i]
                # zipf-ranked pick: head values frequent, tail values rare
                j = min(int(rng.zipf(1.5)) - 1, len(pool) - 1)
                cats.append(pool[j])
        lines.append("\t".join([str(label), *ints, *cats]))
    (data_dir / "train.txt").write_text("\n".join(lines) + "\n")
    return data_dir
