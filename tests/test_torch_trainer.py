"""The port's CLI journey on the CPU: ``python -m tdfo_tpu_torch.launch
synth | preprocess-ctr | train --device cpu`` with ``model_parallel = true``
and ``fused_table_threshold = 0`` (every table fat, packed R = 2 lines at
d = 16).  ``metrics.jsonl`` must carry train loss / train AUC and an eval
AUC in range; the fused update ran through the ``fat_line_update``
wrapper.  The Bert4Rec journey (``synth | preprocess-seq | train`` with
``attn = "flash"``) must log Recall/NDCG and ``test_*`` metrics in range
through the flash wrappers, and its unported knobs name their item.  The
DLRM-Criteo journey (``synth-criteo | preprocess-criteo | train`` with
``stack_tables`` and ``dedup_lookup``) runs the routed fat update once per
step."""

import json
from pathlib import Path

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from tdfo_tpu_torch.core.config import read_configs
from tdfo_tpu_torch.ops.kernels import fat_line_update as tk
from tdfo_tpu_torch.train.trainer import Trainer, pad_batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these steps are tiny, and the suite runs
    several test processes at once, whose thread pools would otherwise
    oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_config(tmp: Path, **extra) -> Path:
    body = {
        "data_dir": str(tmp / "data"), "model": "twotower",
        "model_parallel": True, "embed_dim": 16, "fused_table_threshold": 0,
        "n_epochs": 1, "per_device_train_batch_size": 256,
        "per_device_eval_batch_size": 256, "log_every_n_steps": 4, **extra,
    }
    lines = [f"{k} = {json.dumps(v) if not isinstance(v, bool) else str(v).lower()}"
             for k, v in body.items()]
    path = tmp / "config.toml"
    path.write_text("\n".join(lines) + "\n")
    return path


def test_cli_synth_preprocess_train_cpu(tmp_path, capsys):
    from tdfo_tpu_torch import launch

    cfg = _write_config(tmp_path)
    for cmd in ("synth", "preprocess-ctr"):
        assert launch.main([cmd, "--config", str(cfg)]) == 0
    # in-process: the entry point ``python -m tdfo_tpu_torch.launch`` runs
    assert launch.main(["train", "--config", str(cfg), "--log-dir",
                        str(tmp_path / "logs"), "--device", "cpu"]) == 0
    assert "__fatstack_16_row" in capsys.readouterr().out  # one fat stack
    recs = [json.loads(x) for x in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if "train_loss" in r]
    epoch = [r for r in recs if "train_loss_epoch" in r]
    evals = [r for r in recs if "auc" in r]
    assert steps and np.isfinite([r["train_loss"] for r in steps]).all()
    assert epoch and 0.0 <= epoch[-1]["train_auc"] <= 1.0 and epoch[-1]["steps"] > 4
    assert evals and 0.0 <= evals[-1]["auc"] <= 1.0
    assert np.isfinite(evals[-1]["eval_loss"])


def test_train_defaults_to_the_card(tmp_path):
    from tdfo_tpu_torch import launch

    cfg = _write_config(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            launch.main(["train", "--config", str(cfg)])


def test_trainer_in_process_counts_launches(tmp_path):
    """In-process epoch on the CPU: the packed-form fused update runs
    through the wrapper once per step, and eval reads the trained tables."""
    from tdfo_tpu_torch.data.ctr_preprocessing import run_ctr_preprocessing
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads

    write_synthetic_goodreads(tmp_path / "data")
    run_ctr_preprocessing(tmp_path / "data")
    cfg = read_configs(_write_config(tmp_path))
    tr = Trainer(cfg, device="cpu")
    assert tr.coll.fat_layout_for("__fatstack_16_row").r == 2
    before = tk.fat_line_update.plain_runs
    loss = tr.train_epoch(0)
    assert np.isfinite(loss)
    assert tk.fat_line_update.plain_runs - before == tr._logged_steps > 0
    m = tr.evaluate(0)
    assert 0.0 <= m["auc"] <= 1.0


def test_pad_batch_zero_weights():
    b = {"a": np.arange(3, dtype=np.int32), "b": np.ones((3, 2), np.float32)}
    out, w = pad_batch(b, 5)
    assert out["a"].tolist() == [0, 1, 2, 0, 0] and out["b"].shape == (5, 2)
    assert w.tolist() == [1, 1, 1, 0, 0]


@pytest.mark.parametrize("extra", [
    {"tensorboard": True},
    {"mixed_precision": True, "model": "bert4rec"}, {"lookup_mode": "psum"},
])
def test_unported_knobs_refuse(tmp_path, extra):
    cfg = read_configs(_write_config(tmp_path, **extra))
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item"):
        Trainer(cfg, device="cpu")


@pytest.mark.parametrize("extra,prep", [
    ({"model_parallel": False}, "preprocess-ctr"),
    ({"checkpoint_dir": "ckpt"}, "preprocess-ctr"),
    ({"steps_per_execution": 2}, "preprocess-ctr"),
    ({"model": "bert4rec", "jagged": True}, "preprocess-seq"),
])
def test_formerly_refused_knobs_train_one_epoch(tmp_path, extra, prep):
    """The knobs this port used to refuse (the dense TwoTower regime,
    checkpointing, ``steps_per_execution``, jagged Bert4Rec windows) each
    train one CPU epoch through ``launch`` with finite losses and an eval in
    range; ``checkpoint_dir`` leaves an epoch-complete checkpoint."""
    from tdfo_tpu_torch import launch

    if "checkpoint_dir" in extra:
        extra = {"checkpoint_dir": str(tmp_path / extra["checkpoint_dir"])}
    cfg = _write_config(tmp_path, **extra)
    for cmd in ("synth", prep):
        assert launch.main([cmd, "--config", str(cfg)]) == 0
    tr = launch.run(["train", "--config", str(cfg), "--log-dir",
                     str(tmp_path / "logs"), "--device", "cpu"])
    recs = [json.loads(x) for x in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    epoch = [r for r in recs if "train_loss_epoch" in r]
    assert len(epoch) == 1 and epoch[0]["steps"] > 0
    assert np.isfinite(epoch[0]["train_loss_epoch"])
    assert tr.state.step == epoch[0]["steps"]
    key = "Recall@10" if prep == "preprocess-seq" else "auc"
    assert [0.0 <= r[key] <= 1.0 for r in recs if key in r] == [True] * (
        2 if prep == "preprocess-seq" else 1)
    if "checkpoint_dir" in extra:
        from tdfo_tpu_torch.train.checkpoint import CheckpointManager

        mgr = CheckpointManager(extra["checkpoint_dir"])
        cursor = mgr.read_cursor(mgr.latest_step())
        assert cursor["epoch_complete"] and cursor["global_step"] == tr.state.step


def test_dlrm_criteo_cli_dedup_cpu(tmp_path):
    """``synth-criteo -> preprocess-criteo -> train --device cpu``
    in-process with the Criteo schema, ``stack_tables``, ``dedup_lookup``,
    rowwise_adagrad and a ``fused_table_threshold`` that leaves a fat stack
    (tables above 20 rows) and a plain stack: eval AUC in [0, 1], and the
    routed update ran once per training step, ``fat_line_update`` never."""
    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.data.criteo_preprocessing import (
        CRITEO_CATEGORICAL,
        CRITEO_CONTINUOUS,
    )
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as tkr

    cfg = _write_config(
        tmp_path, model="dlrm", categorical_features=list(CRITEO_CATEGORICAL),
        continuous_features=list(CRITEO_CONTINUOUS), stack_tables=True,
        dedup_lookup=True, sparse_optimizer="rowwise_adagrad",
        fused_table_threshold=20, per_device_train_batch_size=1024,
        per_device_eval_batch_size=1024)
    for cmd in ("synth-criteo", "preprocess-criteo"):
        assert launch.main([cmd, "--config", str(cfg)]) == 0
    counts = lambda: (tk.fat_line_update.plain_runs,  # noqa: E731
                      tkr.fat_line_update_routed.plain_runs)
    before = counts()
    assert launch.main(["train", "--config", str(cfg), "--log-dir",
                        str(tmp_path / "logs"), "--device", "cpu"]) == 0
    recs = [json.loads(x) for x in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    steps = sum(r["steps"] for r in recs if "train_loss_epoch" in r)
    evals = [r for r in recs if "auc" in r]
    assert steps > 0 and evals and 0.0 <= evals[-1]["auc"] <= 1.0
    assert np.isfinite(evals[-1]["eval_loss"])
    fat, routed = (a - b for a, b in zip(counts(), before))
    assert (fat, routed) == (0, steps)
    size_map = json.loads((tmp_path / "data" / "size_map.json").read_text())
    assert min(size_map.values()) <= 20 < max(size_map.values())


def test_bert4rec_flash_fit_cpu(tmp_path):
    """``synth -> preprocess-seq -> train --device cpu`` in-process with
    ``model = "bert4rec"``, ``attn = "flash"`` and a fat item table:
    Recall/NDCG@{10,20,50} for the pre-training eval, every epoch and the
    held-out test split, all in [0, 1]; every step ran the flash forward,
    dQ and dK/dV once per layer and the fused update once."""
    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    cfg = _write_config(tmp_path, model="bert4rec", attn="flash", n_layers=2,
                        per_device_train_batch_size=32,
                        per_device_eval_batch_size=32)
    for cmd in ("synth", "preprocess-seq"):
        assert launch.main([cmd, "--config", str(cfg)]) == 0
    counts = lambda: (tk.fat_line_update.plain_runs, fa.flash_fwd.plain_runs,  # noqa: E731
                      fa.flash_bwd_dq.plain_runs, fa.flash_bwd_dkv.plain_runs)
    before = counts()
    assert launch.main(["train", "--config", str(cfg), "--log-dir",
                        str(tmp_path / "logs"), "--device", "cpu"]) == 0
    recs = [json.loads(x) for x in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    steps = sum(r["steps"] for r in recs if "train_loss_epoch" in r)
    evals = [r for r in recs if "Recall@10" in r]
    tests = [r for r in recs if "test_Recall@10" in r]
    assert steps > 0 and [r["epoch"] for r in evals] == [-1, 0] and len(tests) == 1
    for r in (*evals, *tests):
        vals = [v for k, v in r.items() if "Recall@" in k or "NDCG@" in k]
        assert len(vals) == 6 and all(0.0 <= v <= 1.0 for v in vals), r
    fused, fwd, dq, dkv = (a - b for a, b in zip(counts(), before))
    assert fused == steps and dq == dkv == 2 * steps
    assert fwd > 2 * steps  # training steps plus the eval forwards


@pytest.mark.parametrize("extra,item", [
    ({"attn": "ring_flash"}, 12),
    ({"attn": "ring"}, 12), ({"tensor_parallel": True}, 12),
])
def test_bert4rec_unported_knobs_name_their_item(tmp_path, extra, item):
    cfg = read_configs(_write_config(tmp_path, model="bert4rec", **extra))
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md Queue A item {item}\\)"):
        Trainer(cfg, device="cpu")


def _with_embeddings(path: Path, **emb) -> Path:
    """Append an ``[embeddings]`` table (and its sub-tables) to a written
    config."""
    lines = [f"{k} = {json.dumps(v)}" for k, v in emb.items()
             if not isinstance(v, dict)]
    for k, v in emb.items():
        if isinstance(v, dict):
            lines += [f"[embeddings.{k}]"] + [f"{a} = {json.dumps(b)}"
                                             for a, b in v.items()]
    path.write_text(path.read_text() + "[embeddings]\n" + "\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("extra,emb", [
    ({}, {"table_dtype": "int8"}),
    ({}, {"table_dtype_overrides": {"user_embed": "int8"}}),
    ({}, {"hot_vocab": 8}),
    ({}, {"cache_rows": 64}),
    ({"model": "bert4rec", "mixed_precision": True}, {}),
])
def test_item13_knobs_refuse(tmp_path, extra, emb):
    """int8 storage, hot/cold tables, the update cache and Bert4Rec under
    ``mixed_precision`` still refuse, naming ROADMAP item 13."""
    cfg = read_configs(_with_embeddings(_write_config(tmp_path, **extra), **emb))
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item 13\\)"):
        Trainer(cfg, device="cpu")


def test_bf16_storage_cli_cpu(tmp_path):
    """``launch train --device cpu`` with ``table_dtype = "bfloat16"``,
    ``slot_dtype = "bfloat16"`` and ``mixed_precision`` (f32 compute on the
    CPU, the reference's mapping): the packed-form (d = 16, R = 2) bf16 fat
    stack of the tables above 20 rows runs the plain bf16
    ``fat_line_update`` once per step, the small tables the dense tier,
    and after training every table and every mu/nu is still bf16."""
    from tdfo_tpu_torch import launch

    cfg = _with_embeddings(_write_config(tmp_path, mixed_precision=True,
                                         fused_table_threshold=20),
                           table_dtype="bfloat16", slot_dtype="bfloat16")
    for cmd in ("synth", "preprocess-ctr"):
        assert launch.main([cmd, "--config", str(cfg)]) == 0
    before = tk.fat_line_update.plain_runs
    tr = launch.run(["train", "--config", str(cfg), "--log-dir",
                     str(tmp_path / "logs"), "--device", "cpu"])
    assert tr.state.backbone.dtype == torch.float32
    assert tr.coll.fat_layout_for("__fatstack_16_row_bfloat16").r == 2
    assert tk.fat_line_update.plain_runs - before == tr._logged_steps > 0
    for name, t in tr.state.tables.items():
        assert t.dtype == torch.bfloat16, name
        assert all(s.dtype in (torch.bfloat16, torch.int32)
                   for s in tr.state.slots[name]), name
    assert any(len(s) == 3 for s in tr.state.slots.values())  # plain adam mu/nu
    recs = [json.loads(x) for x in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    evals = [r for r in recs if "auc" in r]
    assert evals and 0.0 <= evals[-1]["auc"] <= 1.0
    assert all(np.isfinite(r["train_loss"]) for r in recs if "train_loss" in r)
