"""``python -m tdfo_tpu_torch.launch serve --device cpu`` journeys, in
process: after a short ``train --device cpu`` with a ``checkpoint_dir``
(the served bundle holds the restored step) for the DMP TwoTower (exact
and int8 two-stage retrieval) and Bert4Rec; from a fresh init for the
dense TwoTower (the quickstart regime) and DLRM-Criteo.  The stats dict
carries the keys the reference's ``serve_from_config`` returns for the
same toml (``requests``, ``batches``, ``p50_ms``, ``p99_ms``, ``shed``,
``swaps``, ``programs``, ``qps``, ``bundle``, ``step`` and ``retrieved``).
The serving knobs that used to refuse (``[serving] replicas > 1``,
``log_features``, ``telemetry.stall_timeout_s``) pass, and serve runs
through them; the command defaults to the card."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from tdfo_tpu_torch import launch
from tdfo_tpu_torch.core.config import read_configs

REFERENCE_KEYS = {"requests", "batches", "p50_ms", "p99_ms", "shed", "swaps",
                  "programs", "qps", "bundle", "step", "retrieved"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toml(tmp: Path, name="config.toml", serving=None, **extra) -> Path:
    body = {"data_dir": str(tmp / "data"), "model": "twotower",
            "model_parallel": True, "embed_dim": 16, "fused_table_threshold": 0,
            "n_epochs": 1, "per_device_train_batch_size": 256,
            "per_device_eval_batch_size": 256, "log_every_n_steps": 4, **extra}
    lines = [f"{k} = {json.dumps(v) if not isinstance(v, bool) else str(v).lower()}"
             for k, v in body.items()]
    if serving:
        lines.append("[serving]")
        lines += [f"{k} = {json.dumps(v) if not isinstance(v, bool) else str(v).lower()}"
                  for k, v in serving.items()]
    path = tmp / name
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.fixture(scope="module")
def goodreads(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_cli")
    cfg = _toml(tmp)
    for cmd in ("synth", "preprocess-ctr", "preprocess-seq"):
        assert launch.main([cmd, "--config", str(cfg)]) == 0
    return tmp


def _check(stats, *, step=None, retrieved=100):
    assert set(stats) == REFERENCE_KEYS, sorted(stats)
    assert stats["requests"] == 64 and stats["shed"] == 0 and stats["swaps"] == 0
    assert 1 <= stats["programs"] <= 3 and stats["retrieved"] == retrieved
    assert all(math.isfinite(stats[k]) for k in ("p50_ms", "p99_ms", "qps"))
    if step is not None:
        assert stats["step"] == step
    assert (Path(stats["bundle"]) / "bundle.json").is_file()


def _train_then_serve(cfg: Path, ck: Path) -> dict:
    launch.run(["train", "--config", str(cfg), "--device", "cpu"])
    from tdfo_tpu_torch.train.checkpoint import CheckpointManager

    step = CheckpointManager(ck).latest_step()
    assert step and step > 0
    stats = launch.run(["serve", "--config", str(cfg), "--device", "cpu"])
    _check(stats, step=step)
    return stats


@pytest.mark.parametrize("serving", [None, {"coarse_k": 150}], ids=["exact", "two_stage"])
def test_serve_twotower_after_train(goodreads, tmp_path, serving):
    ck = tmp_path / "ck"
    cfg = _toml(goodreads, name=f"tt_{bool(serving)}.toml", serving=serving,
                checkpoint_dir=str(ck))
    _train_then_serve(cfg, ck)
    recs = [json.loads(x) for x in (ck / "metrics.jsonl").read_text().splitlines()]
    assert any(r.get("event") == "serve_summary" for r in recs)


def test_serve_bert4rec_after_train(goodreads, tmp_path):
    ck = tmp_path / "ck"
    cfg = _toml(goodreads, name="b4r.toml", model="bert4rec", n_layers=1,
                per_device_train_batch_size=32, per_device_eval_batch_size=32,
                checkpoint_dir=str(ck))
    _train_then_serve(cfg, ck)


@pytest.mark.parametrize("model", ["twotower", "bert4rec"])
def test_serve_stats_keys_are_the_reference_keys(goodreads, tmp_path, model):
    """The reference's ``serve_from_config`` on the same data and toml (a
    fresh init) returns the keys the port's does."""
    from tdfo_tpu.core.config import read_configs as j_read
    from tdfo_tpu.serve.frontend import serve_from_config as j_serve

    extra = {"n_layers": 1} if model == "bert4rec" else {}
    cfg = _toml(goodreads, name=f"ref_{model}.toml", model=model, **extra)
    jcfg = j_read(str(cfg))
    if model == "bert4rec":
        jcfg = jcfg.replace(size_map=json.loads(
            (goodreads / "data" / "size_map_bert4rec.json").read_text()))
    got = j_serve(jcfg, log_dir=tmp_path / "j", n_requests=4)
    assert set(got) == REFERENCE_KEYS


def test_serve_dense_twotower_fresh_init(goodreads, tmp_path):
    cfg = _toml(goodreads, name="dense.toml", model_parallel=False)
    stats = launch.run(["serve", "--config", str(cfg), "--device", "cpu",
                        "--log-dir", str(tmp_path)])
    _check(stats, step=0)
    assert json.loads((tmp_path / "serving_bundle" / "bundle.json").read_text())[
        "kind"] == "dense"


def test_serve_dlrm_criteo_fresh_init(tmp_path):
    from tdfo_tpu_torch.data.criteo_preprocessing import (
        CRITEO_CATEGORICAL,
        CRITEO_CONTINUOUS,
    )
    from tdfo_tpu_torch.data.synthetic import write_synthetic_criteo

    cfg = _toml(tmp_path, name="dlrm.toml", model="dlrm",
                categorical_features=list(CRITEO_CATEGORICAL),
                continuous_features=list(CRITEO_CONTINUOUS), stack_tables=True,
                dedup_lookup=True, sparse_optimizer="rowwise_adagrad",
                fused_table_threshold=20)
    write_synthetic_criteo(tmp_path / "data", n_rows=1000)
    assert launch.main(["preprocess-criteo", "--config", str(cfg)]) == 0
    stats = launch.run(["serve", "--config", str(cfg), "--device", "cpu",
                        "--log-dir", str(tmp_path / "logs")])
    # DLRM's interaction head has no towers: no retrieval round
    assert set(stats) == REFERENCE_KEYS - {"retrieved"}
    assert stats["requests"] == 64 and stats["step"] == 0


@pytest.mark.parametrize("serving,telemetry,item", [
    ({"replicas": 2}, None, "15b"),
    ({"log_features": True}, None, "16"),
    (None, {"stall_timeout_s": 5.0}, "16"),
])
def test_unported_serving_knobs_refuse(goodreads, serving, telemetry, item):
    """The three serving knobs that refused (naming ``item``) are ported:
    the fleet, the request log and the stall watchdog pass the port's
    check, for serving and for training alike."""
    from tdfo_tpu_torch.train.trainer import refuse_unported

    cfg = read_configs(_toml(goodreads, name="refuse.toml", serving=serving))
    if telemetry:
        cfg = cfg.replace(telemetry=cfg.telemetry.__class__(**telemetry))
    refuse_unported(cfg, device="cpu")


def test_serve_defaults_to_the_card(goodreads):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        launch.run(["serve", "--config", str(_toml(goodreads, name="card.toml"))])
    assert np.isfinite(1.0)
