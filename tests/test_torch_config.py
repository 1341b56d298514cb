"""One TOML drives both packages: the port's ``read_configs`` gives the same
``asdict`` as the JAX package's and refuses the same configs."""

import dataclasses
from pathlib import Path

import jax  # noqa: F401
import pytest
import torch  # noqa: F401

from tdfo_tpu.core import config as jcfg
from tdfo_tpu_torch.core import config as tcfg

ROOT = Path(__file__).resolve().parents[1]
TOMLS = [ROOT / "config.toml", *sorted((ROOT / "configs").glob("*.toml"))]


@pytest.mark.parametrize("path", TOMLS, ids=lambda p: p.name)
def test_toml_parses_identically(path):
    j = dataclasses.asdict(jcfg.read_configs(path))
    t = dataclasses.asdict(tcfg.read_configs(path))
    assert t == j


def test_defaults_and_fields_identical():
    assert dataclasses.asdict(tcfg.Config()) == dataclasses.asdict(jcfg.Config())
    for name in ("Config", "MeshSpec", "EmbeddingsSpec", "ServingSpec",
                 "LoadgenSpec", "TrainSpec", "TelemetrySpec", "OnlineSpec",
                 "PlannerSpec", "FaultSpec"):
        jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jcfg, name))]
        tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tcfg, name))]
        assert tf == jf, name


# rejection cases of tests/test_config.py, as read_configs overrides
REJECTED = [
    {"bogus_key": 1},
    {"max_len": 5, "sliding_step": 10},
    {"write_format": "csv"},
    {"model": "gpt"},
    {"embedding_sharding": "diagonal"},
    {"lookup_mode": "magic"},
    {"dedup_lookup": True, "lookup_mode": "psum"},
    {"a2a_capacity_factor": -1.0},
    {"jagged": True},
    {"model": "bert4rec", "write_format": "tfrecord"},
    {"attn": "sparse"},
    {"ring_block_k": 4},
    {"sparse_optimizer": "lamb"},
    {"steps_per_execution": 0},
    {"checkpoint_every_n_steps": -1},
    {"max_bad_shards": -1},
    {"nonfinite_tolerance": -1},
    {"snapshot_every_n_steps": 0},
    {"streaming": False, "write_format": "tfrecord"},
    {"fused_table_threshold": -2},
    {"faults": {"kill_at_step": -1}},
    {"faults": {"bogus": 1}},
    {"mesh": {"bogus": 1}},
    {"embeddings": {"hot_vocab": -1}},
    {"embeddings": {"hot_fraction": 0.0}},
    {"embeddings": {"hot_vocab": 8}, "lookup_mode": "psum"},
    {"embeddings": {"table_dtype": "float16"}},
    {"embeddings": {"slot_dtype": "int8"}},
    {"embeddings": {"table_dtype": "bfloat16"}},
    {"embeddings": {"grouped_a2a": True}},
    {"train": {"pipeline_overlap": True}},
    {"serving": {"top_k": 0}},
    {"serving": {"buckets": [8, 4]}},
    {"serving": {"shed_policy": "random"}},
    {"online": {"lag_policy": "maybe"}},
    {"online": {"request_log": "log"}},
    {"loadgen": {"zipf_a": 1.0}},
    {"planner": {"n_devices": 0}},
    {"telemetry": {"stall_timeout_s": -1.0}},
]


@pytest.mark.parametrize("overrides", REJECTED, ids=lambda o: ",".join(o))
def test_both_packages_refuse(overrides):
    with pytest.raises(ValueError):
        jcfg.read_configs(None, **overrides)
    with pytest.raises(ValueError):
        tcfg.read_configs(None, **overrides)


def test_size_map_handshake(tmp_path):
    (tmp_path / "size_map.json").write_text('{"user": 100, "item": 50}')
    j = jcfg.read_configs(None, data_dir=str(tmp_path))
    t = tcfg.read_configs(None, data_dir=str(tmp_path))
    assert t.size_map == j.size_map == {"user": 100, "item": 50}
