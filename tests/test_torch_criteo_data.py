"""Criteo data path through both packages: ``write_synthetic_criteo`` with
the same seed writes a byte-identical ``train.txt``, and
``run_criteo_preprocessing`` on it writes byte-identical parquet shards and
``size_map.json`` (small chunks, so the streaming passes and the per-chunk
eval shard rotation are exercised).  With ``hot_vocab > 0`` both write the
same ``hot_ids.json`` byte for byte."""

import json

import jax  # noqa: F401

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
    """``hot_vocab > 0`` (refused until the hot/cold tables were ported)
    now writes the reference's ``hot_ids.json`` byte for byte: per table the
    smallest frequency-ranked prefix covering ``hot_fraction`` of the
    pass-1 lookup mass (id 0 folding the OOV mass), capped at
    ``hot_vocab`` ids."""
    j, t = tmp_path / "jax", tmp_path / "torch"
    jsyn.write_synthetic_criteo(j, n_rows=400, seed=6)
    tsyn.write_synthetic_criteo(t, n_rows=400, seed=6)
    kw = dict(KW, file_num=2, hot_vocab=8, hot_fraction=0.7)
    assert jprep.run_criteo_preprocessing(j, **kw) == tprep.run_criteo_preprocessing(t, **kw)
    got = (t / "hot_ids.json").read_bytes()
    assert got == (j / "hot_ids.json").read_bytes()
    tables = json.loads(got)["tables"]
    assert len(tables) == 26 and all(0 < len(v) <= 8 for v in tables.values())
