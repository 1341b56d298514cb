"""The Bert4Rec ETL of the PyTorch port against the JAX package:
``run_seq_preprocessing`` of both on the same synthetic raw fixture writes
byte-identical parquet shards (every split: train windows, eval and test
candidates) and an identical ``size_map_bert4rec.json``; the port's loader
stacks the fixed-width list columns into ``[B, T]`` / ``[B, 101]``
arrays."""

from pathlib import Path

import jax  # noqa: F401
import numpy as np
import pandas as pd
import pytest

from tdfo_tpu.data import seq_preprocessing as jseq
from tdfo_tpu_torch.data import seq_preprocessing as tseq
from tdfo_tpu_torch.data import synthetic as tsyn
from tdfo_tpu_torch.data.loader import ParquetStream, resolve_files


@pytest.fixture(scope="module")
def two_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq")
    j, t = root / "jax", root / "torch"
    for d in (j, t):
        tsyn.write_synthetic_goodreads(d, seed=5)
    stats = (jseq.run_seq_preprocessing(j, max_len=12, sliding_step=6, seed=9),
             tseq.run_seq_preprocessing(t, max_len=12, sliding_step=6, seed=9))
    return j, t, stats


def test_shards_and_size_map_identical(two_dirs):
    j, t, (js, ts) = two_dirs
    assert js == ts
    assert ((j / "size_map_bert4rec.json").read_bytes()
            == (t / "size_map_bert4rec.json").read_bytes())
    names = sorted(p.name for p in (j / "parquet_bert4rec").iterdir())
    assert names == sorted(p.name for p in (t / "parquet_bert4rec").iterdir())
    assert {n.split("_part_")[0] for n in names} == {"train", "eval", "test"}
    for n in names:
        a, b = j / "parquet_bert4rec" / n, t / "parquet_bert4rec" / n
        fa, fb = pd.read_parquet(a), pd.read_parquet(b)
        assert list(fa.columns) == list(fb.columns) and len(fa) == len(fb) > 0
        for col in fa.columns:  # every column, every row
            assert all(np.array_equal(x, y) for x, y in zip(fa[col], fb[col])), (n, col)
        assert a.read_bytes() == b.read_bytes(), n


def test_loader_stacks_fixed_width_sequences(two_dirs):
    _, t, (_, stats) = two_dirs
    files = resolve_files(t, str(Path("parquet_bert4rec") / "eval_part_*.parquet"))
    batch = next(iter(ParquetStream(files, batch_size=8, shuffle=False,
                                    drop_last=False)))
    assert batch["eval_seqs"].shape == (8, 12)
    assert batch["candidate_items"].shape == (8, jseq.EVAL_NEG_NUM + 1)
    assert (batch["eval_seqs"][:, -1] == stats["n_items"] + 1).all()  # MASK last
