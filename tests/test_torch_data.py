"""CTR data path through both packages: the same seed gives byte-identical
raw files, ``size_map.json`` and parquet frames, and the loaders give the
same batch sequence."""

import json
from pathlib import Path

import jax  # noqa: F401
import numpy as np
import pandas as pd
import pytest
import torch

from tdfo_tpu.data import ctr_preprocessing as jprep
from tdfo_tpu.data import loader as jload
from tdfo_tpu.data import synthetic as jsyn
from tdfo_tpu_torch.data import ctr_preprocessing as tprep
from tdfo_tpu_torch.data import loader as tload
from tdfo_tpu_torch.data import synthetic as tsyn


@pytest.fixture(scope="module")
def two_dirs(tmp_path_factory):
    j = tmp_path_factory.mktemp("jax")
    t = tmp_path_factory.mktemp("torch")
    jsyn.write_synthetic_goodreads(j, seed=3)
    tsyn.write_synthetic_goodreads(t, seed=3)
    jprep.run_ctr_preprocessing(j, seed=42)
    tprep.run_ctr_preprocessing(t, seed=42)
    return j, t


def test_raw_files_and_size_map_identical(two_dirs):
    j, t = two_dirs
    for name in ("goodreads_interactions.csv", "goodreads_books.json",
                 "user_id_map.csv", "book_id_map.csv", "size_map.json"):
        assert (t / name).read_bytes() == (j / name).read_bytes(), name
    assert json.loads((t / "size_map.json").read_text())["user"] == 120


def test_parquet_frames_equal(two_dirs):
    j, t = two_dirs
    jfiles = sorted(p.name for p in (j / "parquet").glob("*.parquet"))
    tfiles = sorted(p.name for p in (t / "parquet").glob("*.parquet"))
    assert tfiles == jfiles and len(jfiles) == 16
    for name in jfiles:
        pd.testing.assert_frame_equal(pd.read_parquet(t / "parquet" / name),
                                      pd.read_parquet(j / "parquet" / name))


@pytest.mark.parametrize("shuffle,drop_last,buffer", [
    (True, True, 500), (False, False, 2_000_000)])
def test_loader_batch_sequence_identical(two_dirs, shuffle, drop_last, buffer):
    j, _ = two_dirs
    files = jload.resolve_files(j, "parquet/train_part_*.parquet")
    kw = dict(shuffle=shuffle, buffer_size=buffer, seed=7, drop_last=drop_last,
              process_index=0, process_count=1)
    for epoch in (0, 1):
        js = jload.ParquetStream(files, 128, **kw)
        ts = tload.ParquetStream(files, 128, **kw)
        js.set_epoch(epoch)
        ts.set_epoch(epoch)
        jb, tb = list(js), list(ts)
        assert len(tb) == len(jb) > 2
        for a, b in zip(tb, jb):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_map_stream_and_prefetch(two_dirs):
    j, _ = two_dirs
    files = jload.resolve_files(j, "parquet/eval_part_*.parquet")
    jb = list(jload.MapStream(files, 100, seed=1, drop_last=False))
    tb = list(tload.MapStream(files, 100, seed=1, drop_last=False))
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    dev = list(tload.prefetch_to_device(iter(tb), "cpu", size=2))
    assert len(dev) == len(tb)
    for a, b in zip(dev, tb):
        for k in a:
            assert isinstance(a[k], torch.Tensor)
            np.testing.assert_array_equal(a[k].numpy(), b[k])


def test_unported_etl_options_refuse(tmp_path: Path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tprep.run_ctr_preprocessing(tmp_path, hot_vocab=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tprep.run_ctr_preprocessing(tmp_path, write_format="tfrecord")
