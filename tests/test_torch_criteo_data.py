"""Criteo data path through both packages: ``write_synthetic_criteo`` with
the same seed writes a byte-identical ``train.txt``, and
``run_criteo_preprocessing`` on it writes byte-identical parquet shards and
``size_map.json`` (small chunks, so the streaming passes and the per-chunk
eval shard rotation are exercised).  ``hot_vocab > 0`` refuses, naming its
item."""

import jax  # noqa: F401
import pytest

from tdfo_tpu.data import criteo_preprocessing as jprep
from tdfo_tpu.data import synthetic as jsyn
from tdfo_tpu_torch.data import criteo_preprocessing as tprep
from tdfo_tpu_torch.data import synthetic as tsyn

KW = dict(min_freq=3, eval_fraction=0.2, file_num=3, seed=5, chunksize=200)


def test_synth_and_etl_byte_identical(tmp_path):
    j, t = tmp_path / "jax", tmp_path / "torch"
    jsyn.write_synthetic_criteo(j, n_rows=700, seed=4)
    tsyn.write_synthetic_criteo(t, n_rows=700, seed=4)
    assert (t / "train.txt").read_bytes() == (j / "train.txt").read_bytes()
    want = jprep.run_criteo_preprocessing(j, **KW)
    got = tprep.run_criteo_preprocessing(t, **KW)
    assert got == want and len(got) == 26
    assert (t / "size_map.json").read_bytes() == (j / "size_map.json").read_bytes()
    names = sorted(p.name for p in (j / "parquet").glob("*.parquet"))
    assert sorted(p.name for p in (t / "parquet").glob("*.parquet")) == names
    assert {n.split("_")[0] for n in names} == {"train", "eval"}
    for name in names:
        assert ((t / "parquet" / name).read_bytes()
                == (j / "parquet" / name).read_bytes()), name
    assert not (t / "table_stats.json").exists()  # planner artifact: item 14


def test_hot_vocab_refuses(tmp_path):
    with pytest.raises(NotImplementedError, match="item 13"):
        tprep.run_criteo_preprocessing(tmp_path, hot_vocab=8)
