"""Goodreads sequential ETL — Bert4Rec masked-LM training + sampled eval data.

Port of ``tdfo_tpu/data/seq_preprocessing.py``: the same pandas/numpy code,
writing byte-identical shards and ``size_map_bert4rec.json``; shard
slicing comes from the port's own ``data/shards.py``.  The reference's
docstring follows.

Capability parity with ``torchrec/preprocessing.py``, re-implemented on
pandas/numpy with vectorised window generation (the reference loops per user,
``torchrec/preprocessing.py:194-221``):

  * interactions: users with 20..200 interactions, per-user sorted items
    (``:28-43``); ids remapped 1-based contiguous, PAD_ID=0,
    MASK_ID=n_items+1 (``:14-15,46-72``).
  * split: leave-last-two — last item test, second-to-last eval, rest train
    (``:83-109``; the reference computes the test item and then only keeps
    train/eval — here all three are returned and train/eval written).
  * masking: each train item masked with prob ``mask_prob``; the LAST item of
    every user sequence is always masked (paper protocol, ``:112-150``);
    labels = original item where masked else PAD_ID.
  * sliding windows: length ``max_len``, stride ``sliding_step``, PAD-padded
    tail (``:194-221``).
  * eval: last ``max_len - 1`` train items + MASK, LEFT-padded to ``max_len``
    (``:229-239``); candidates = [eval item] + 100 popularity-sampled
    negatives excluding the user's positives (``:16,260-315``).
  * output: 2 pandas-parquet shards per split (list columns), train shuffled
    seed 42 (``:318-334``), plus ``size_map_bert4rec.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pandas as pd

from tdfo_tpu_torch.data.shards import shard_ranges, write_df_part

__all__ = ["run_seq_preprocessing", "PAD_ID", "EVAL_NEG_NUM"]

MIN_INTERACTIONS = 20
MAX_INTERACTIONS = 200
PAD_ID = 0
EVAL_NEG_NUM = 100
FILE_NUM = 2


def read_interactions(data_dir: Path) -> pd.DataFrame:
    df = pd.read_csv(
        data_dir / "goodreads_interactions.csv",
        dtype={"user_id": np.int32, "book_id": np.int32},
        usecols=["user_id", "book_id"],
    )
    counts = df.groupby("user_id")["book_id"].transform("size")
    df = df[(counts >= MIN_INTERACTIONS) & (counts <= MAX_INTERACTIONS)]
    return df.sort_values(["user_id", "book_id"], kind="stable").reset_index(drop=True)


def map_ids(df: pd.DataFrame) -> tuple[pd.DataFrame, int, int]:
    """1-based contiguous ids; 0 is PAD, n_items+1 becomes MASK."""
    out = pd.DataFrame(index=df.index)
    sizes = {}
    for col in ("user_id", "book_id"):
        uniq = np.sort(df[col].unique())
        mapping = pd.Series(np.arange(1, len(uniq) + 1, dtype=np.int32), index=uniq)
        out[col] = mapping[df[col].to_numpy()].to_numpy()
        sizes[col] = len(uniq)
    n_users, n_items = sizes["user_id"], sizes["book_id"]
    assert out["user_id"].min() == 1 and out["user_id"].max() == n_users
    assert out["book_id"].min() == 1 and out["book_id"].max() == n_items
    return out, n_users, n_items


def item_popularity(df: pd.DataFrame) -> tuple[np.ndarray, np.ndarray]:
    counts = df["book_id"].value_counts()
    items = counts.index.to_numpy(dtype=np.int32)
    probs = (counts.to_numpy() / counts.sum()).astype(np.float64)
    return items, probs


def split_leave_last_two(df: pd.DataFrame) -> pd.DataFrame:
    """Per user (items sorted): train = seq[:-2], eval = seq[-2], test = seq[-1]."""
    g = df.groupby("user_id")["book_id"]
    agg = g.agg(list)
    return pd.DataFrame({
        "user_id": agg.index.to_numpy(dtype=np.int32),
        "train": [np.asarray(s[:-2], np.int32) for s in agg],
        "eval_item": np.asarray([s[-2] for s in agg], np.int32),
        "test_item": np.asarray([s[-1] for s in agg], np.int32),
    })


def mask_train_sequences(
    split: pd.DataFrame, mask_prob: float, mask_id: int, rng: np.random.Generator
) -> tuple[list[np.ndarray], list[np.ndarray], float]:
    """BERT-style masking + always-mask-last; returns (inputs, labels, ratio)."""
    inputs, labels = [], []
    n_masked = n_total = 0
    for seq in split["train"]:
        draw = rng.random(len(seq), dtype=np.float32)
        m = draw <= mask_prob
        if len(m):
            m[-1] = True  # always mask the final item (paper protocol)
        inp = np.where(m, mask_id, seq).astype(np.int32)
        lab = np.where(m, seq, PAD_ID).astype(np.int32)
        inputs.append(inp)
        labels.append(lab)
        n_masked += int(m.sum())
        n_total += len(seq)
    ratio = n_masked / max(n_total, 1)
    return inputs, labels, ratio


def sliding_windows(
    user_ids: np.ndarray,
    inputs: list[np.ndarray],
    labels: list[np.ndarray],
    max_len: int,
    step: int,
    pad: bool = True,
) -> pd.DataFrame:
    """Windows of ``max_len`` at stride ``step`` over each user's sequence.

    ``pad=True`` PAD-pads every window to ``max_len`` (offline padding, the
    original recipe).  ``pad=False`` writes RAGGED windows — true lengths
    only, no storage wasted on padding — for the runtime jagged path
    (``Config.jagged``), where the trainer ships (values, lengths) and
    ``jagged_to_dense`` runs inside the jitted step (torchrec KJT parity,
    ``torchrec/train.py:33-41``).
    """
    users, starts, seq_idx = [], [], []
    for i, (u, seq) in enumerate(zip(user_ids, inputs)):
        for s in range(0, max(len(seq), 1), step):
            users.append(u)
            starts.append(s)
            seq_idx.append(i)
    if pad:
        win_items = np.full((len(starts), max_len), PAD_ID, np.int32)
        win_labels = np.full((len(starts), max_len), PAD_ID, np.int32)
        for row, (i, s) in enumerate(zip(seq_idx, starts)):
            chunk = inputs[i][s : s + max_len]
            win_items[row, : len(chunk)] = chunk
            lab = labels[i][s : s + max_len]
            win_labels[row, : len(lab)] = lab
        items_col, labels_col = list(win_items), list(win_labels)
    else:
        items_col = [inputs[i][s : s + max_len].astype(np.int32)
                     for i, s in zip(seq_idx, starts)]
        labels_col = [labels[i][s : s + max_len].astype(np.int32)
                      for i, s in zip(seq_idx, starts)]
    return pd.DataFrame({
        "user_id": np.asarray(users, np.int32),
        "train_interactions": items_col,
        "labels": labels_col,
    })


def eval_sequences(split: pd.DataFrame, max_len: int, mask_id: int) -> list[np.ndarray]:
    """(train tail + MASK) right-aligned in a LEFT-padded window of max_len."""
    seqs = []
    for seq in split["train"]:
        tail = np.concatenate([seq[-(max_len - 1):], [mask_id]]).astype(np.int32)
        out = np.full((max_len,), PAD_ID, np.int32)
        out[-len(tail):] = tail
        seqs.append(out)
    return seqs


def test_sequences(split: pd.DataFrame, max_len: int, mask_id: int) -> list[np.ndarray]:
    """Leave-one-out TEST inputs: by test time the eval item is known history,
    so the window is (train + eval_item) tail + MASK.  The reference computes
    its test split and never consumes it (``train_val_test`` neither writes
    nor evaluates it, ``torchrec/train.py:147-177``) — this
    framework writes test shards and runs a final post-fit test evaluation."""
    seqs = []
    for seq, ev in zip(split["train"], split["eval_item"]):
        hist = np.concatenate([seq, [ev]])
        tail = np.concatenate([hist[-(max_len - 1):], [mask_id]]).astype(np.int32)
        out = np.full((max_len,), PAD_ID, np.int32)
        out[-len(tail):] = tail
        seqs.append(out)
    return seqs


def sample_negatives(
    split: pd.DataFrame,
    items: np.ndarray,
    probs: np.ndarray,
    rng: np.random.Generator,
    n_neg: int = EVAL_NEG_NUM,
    extra_positives: list[np.ndarray] | None = None,
) -> list[np.ndarray]:
    """Per user: ``n_neg`` unique popularity-weighted negatives excluding the
    user's positives (train + eval item, plus ``extra_positives`` rows — the
    test split passes the test item so test candidates never leak it).

    Shared-pool amortisation (the reference's scheme, ``:260-299``): weighted
    no-replacement draws cost O(n_items) each, so one pool serves many users —
    each user consumes a slice sized ``n_pos + n_neg + slack``, set-differences
    its positives, and only the rare short rows trigger a per-user top-up.
    Unlike the reference (set-difference then ``head(100)``, which can leave
    SHORT rows), every user here ends with exactly ``n_neg`` candidates
    (fixed-width rows batch with static shapes); only a catalog smaller than
    positives + n_neg cycle-pads with duplicates."""
    n_avail = len(items)
    needs = [len(seq) + n_neg + 16 for seq in split["train"]]
    chunk = max(min(n_avail, max(needs)), min(n_avail, 4 * n_neg))

    pool = np.empty((0,), np.int64)

    def refill(min_size: int):
        nonlocal pool
        parts = [pool]
        have = len(pool)
        while have < min_size:
            draw = rng.choice(items, size=chunk, replace=False, p=probs)
            parts.append(draw)
            have += chunk
        pool = np.concatenate(parts)

    extras = extra_positives or [np.empty((0,), np.int32)] * len(split)
    out = []
    for seq, ev, extra, need in zip(split["train"], split["eval_item"], extras, needs):
        pos = set(seq.tolist())
        pos.add(int(ev))
        pos.update(int(x) for x in np.atleast_1d(extra))
        want = min(n_neg, n_avail - len(pos))
        refill(need)
        slice_, pool = pool[:need], pool[need:]
        keep = pd.unique(slice_[~np.isin(slice_, list(pos))])[:n_neg]
        while len(keep) < want:  # rare: slack eaten by overlap/duplicates
            refill(chunk)
            top_up, pool = pool[:chunk], pool[chunk:]
            top_up = top_up[~np.isin(top_up, list(pos))]
            keep = pd.unique(np.concatenate([keep, top_up]))[:n_neg]
        if len(keep) < n_neg:  # tiny catalog: duplicate rather than go ragged
            keep = np.resize(keep, n_neg)
        out.append(keep.astype(np.int32))
    return out


def write_shards(data_dir: Path, df: pd.DataFrame, prefix: str, *,
                 file_num: int = FILE_NUM, seed: int = 42) -> list[Path]:
    write_dir = data_dir / "parquet_bert4rec"
    write_dir.mkdir(exist_ok=True)
    return [
        write_df_part(df.iloc[start:end], write_dir, prefix, i,
                      shuffle=prefix == "train", seed=seed)
        for i, start, end in shard_ranges(len(df), file_num)
    ]


def run_seq_preprocessing(
    data_dir: str | Path,
    *,
    max_len: int = 20,
    sliding_step: int = 10,
    mask_prob: float = 0.2,
    seed: int = 42,
    file_num: int = FILE_NUM,
    pad: bool = True,
) -> dict[str, int]:
    """Full ETL: raw interactions -> masked train windows + eval candidates.
    ``pad=False`` writes ragged train windows for the runtime jagged path."""
    data_dir = Path(data_dir)
    rng = np.random.default_rng(seed)

    raw = read_interactions(data_dir)
    data, n_users, n_items = map_ids(raw)
    mask_id = n_items + 1
    items, probs = item_popularity(data)
    with open(data_dir / "size_map_bert4rec.json", "w") as f:
        json.dump({"n_users": n_users, "n_items": n_items}, f, indent=4)

    split = split_leave_last_two(data)
    inputs, labels, ratio = mask_train_sequences(split, mask_prob, mask_id, rng)
    train_df = sliding_windows(
        split["user_id"].to_numpy(), inputs, labels, max_len, sliding_step,
        pad=pad,
    )
    write_shards(data_dir, train_df, "train", file_num=file_num, seed=seed)

    eval_seqs = eval_sequences(split, max_len, mask_id)
    negs = sample_negatives(split, items, probs, rng)
    eval_df = pd.DataFrame({
        "user_id": split["user_id"],
        "eval_seqs": eval_seqs,
        "candidate_items": [
            np.concatenate([[ev], ng]).astype(np.int32)
            for ev, ng in zip(split["eval_item"], negs)
        ],
    })
    write_shards(data_dir, eval_df, "eval", file_num=file_num, seed=seed)

    # test split (leave-last-one): the reference computes test_item and drops
    # it (torchrec/preprocessing.py:83-109, train.py:147-177); here it is
    # written with the SAME column names as eval so the trainer's eval
    # machinery serves both by swapping the file pattern.
    tst_seqs = test_sequences(split, max_len, mask_id)
    tst_negs = sample_negatives(
        split, items, probs, rng,
        extra_positives=[np.asarray([t], np.int32) for t in split["test_item"]],
    )
    test_df = pd.DataFrame({
        "user_id": split["user_id"],
        "eval_seqs": tst_seqs,
        "candidate_items": [
            np.concatenate([[t], ng]).astype(np.int32)
            for t, ng in zip(split["test_item"], tst_negs)
        ],
    })
    write_shards(data_dir, test_df, "test", file_num=file_num, seed=seed)
    return {"n_users": n_users, "n_items": n_items, "masked_ratio": ratio}
