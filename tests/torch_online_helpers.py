"""Shared set-up of the online-loop parity tests (``test_torch_online*.py``):
the synthetic data and request logs both packages replay, the loop
configuration, the reference's loop at one device, and the carry of the
reference's initial state into the port as its step-0 checkpoint.

Both loops replay the same log bytes (written once, with the port's
``RequestLog``, byte-identical to the reference writer's) from the same
initial state: the reference's ``OnlineLoop`` initialises it, and the port
restores it from a checkpoint written before its loop starts, as a
resumed run would (``OnlineLoop.__init__`` restores the newest
checkpoint).  The reference runs at one CPU device (its trainer's mesh is
built over the first device only), the port's batch is then the
reference's global batch.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = str(Path(__file__).resolve().parents[1])
BATCH = 32
STEPS_PER_CYCLE = 2


def ctr_env(root: Path, *, n_batches: int, replicas: int = 0, seed: int = 7,
            label_from_rating: bool = False) -> dict:
    """Synthetic goodreads data + a request log holding ``n_batches``
    batches of rows plus a sub-batch tail (``replicas > 0``: the fleet
    layout, one log per replica, records interleaved).
    ``label_from_rating``: labels are ``avg_rating > 0.5``, so the canary
    skew fault (which serves ``-avg_rating``) craters held-out AUC."""
    from tdfo_tpu_torch.core.config import load_size_map, read_configs
    from tdfo_tpu_torch.data.ctr_preprocessing import run_ctr_preprocessing
    from tdfo_tpu_torch.data.replay import RequestLog, replica_log_dir
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads
    from tdfo_tpu_torch.serve.frontend import _column_vocab
    from tdfo_tpu_torch.train.trainer import _ctr_columns

    d = root / "data"
    write_synthetic_goodreads(d, n_users=80, n_books=120,
                              interactions_per_user=(15, 40), seed=13)
    run_ctr_preprocessing(d)
    cfg = read_configs(None, data_dir=str(d), model="twotower",
                       model_parallel=True, size_map=load_size_map(str(d)))
    cat_cols, cont_cols = _ctr_columns(cfg)
    vocab = _column_vocab(cfg, cat_cols)
    rl = root / "rl"
    logs = ([RequestLog(replica_log_dir(rl, k), segment_bytes=4096)
             for k in range(replicas)] if replicas
            else [RequestLog(rl, segment_bytes=4096)])
    rng = np.random.default_rng(seed)
    rows, total, i = {}, 0, 0
    while total < n_batches * BATCH + 5:
        n = int(rng.integers(3, 9))
        feats = {c: rng.integers(0, vocab[c], size=n).tolist() for c in cat_cols}
        for c in cont_cols:
            feats[c] = [round(float(v), 6) for v in rng.random(n)]
        feats["label"] = ([int(v > 0.5) for v in feats[cont_cols[0]]]
                          if label_from_rating
                          else rng.integers(0, 2, size=n).tolist())
        k = i % len(logs)
        seq = logs[k].append({"event": "serve_request", "request": f"r{total}",
                              "rows": n, "outcome": "ok", "features": feats})
        rows[(k, seq)] = n
        total, i = total + n, i + 1
    for log in logs:
        log.close()
    return dict(data_dir=str(d), request_log=str(rl), rows=rows,
                size_map=load_size_map(str(d)), cat_cols=cat_cols,
                cont_cols=cont_cols, vocab=vocab)


def seq_env(root: Path, *, n_batches: int, max_len: int = 8, seed: int = 5) -> dict:
    """Synthetic goodreads data through the seq ETL + a request log of
    eval windows (``history_window``) with 1 + 100 candidate panels."""
    from tdfo_tpu_torch.data.seq_preprocessing import run_seq_preprocessing
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads
    from tdfo_tpu_torch.data.replay import RequestLog
    from tdfo_tpu_torch.serve.seq_scoring import history_window

    d = root / "data"
    write_synthetic_goodreads(d, n_users=60, n_books=150,
                              interactions_per_user=(10, 30), seed=17)
    run_seq_preprocessing(d, max_len=max_len, sliding_step=4, seed=0)
    size_map = json.loads((d / "size_map_bert4rec.json").read_text())
    n_items = int(size_map["n_items"])
    log = RequestLog(root / "rl", segment_bytes=4096)
    rng = np.random.default_rng(seed)
    total = 0
    while total < n_batches * BATCH + 3:
        n = int(rng.integers(2, 7))
        seqs = [history_window(rng.integers(1, n_items + 1,
                                            size=int(rng.integers(1, 2 * max_len))),
                               n_items=n_items, max_len=max_len).tolist()
                for _ in range(n)]
        cands = rng.integers(1, n_items + 1, size=(n, 101)).tolist()
        log.append({"event": "serve_request", "request": f"s{total}", "rows": n,
                    "outcome": "ok", "features": {"seqs": seqs, "cands": cands}})
        total += n
    log.close()
    return dict(data_dir=str(d), request_log=str(root / "rl"), size_map=size_map,
                max_len=max_len)


def loop_kwargs(env: dict, ckpt: Path, *, seq: bool = False, online=None,
                serving=None, faults=None, telemetry=None) -> dict:
    """``read_configs`` keywords of a loop run (both packages take them)."""
    kw = dict(
        data_dir=env["data_dir"], n_epochs=1, learning_rate=3e-3,
        per_device_train_batch_size=BATCH, per_device_eval_batch_size=BATCH,
        log_every_n_steps=1000, size_map=env["size_map"],
        checkpoint_dir=str(ckpt), faults=dict(faults or {}),
        online={"request_log": env["request_log"],
                "steps_per_cycle": STEPS_PER_CYCLE, "max_cycles": 0,
                **(online or {})})
    if seq:
        kw.update(model="bert4rec", model_parallel=True, max_len=env["max_len"],
                  embed_dim=16, n_heads=2, n_layers=1, dropout=0.0,
                  sliding_step=4, attn="full")
    else:
        kw.update(model="twotower", model_parallel=True, embed_dim=8)
    if serving:
        kw["serving"] = dict(serving)
    if telemetry:
        kw["telemetry"] = dict(telemetry)
    return kw


def jax_loop(monkeypatch, kw: dict, log_dir: Path):
    """The reference's ``OnlineLoop`` at one CPU device."""
    import jax

    from tdfo_tpu.core import mesh as jmesh
    from tdfo_tpu.core.config import read_configs
    from tdfo_tpu.train import trainer as jtrainer
    from tdfo_tpu.train.online import OnlineLoop

    monkeypatch.setattr(jtrainer, "make_mesh",
                        lambda spec=None: jmesh.make_mesh(spec, devices=jax.devices()[:1]))
    return OnlineLoop(read_configs(None, **kw), log_dir=str(log_dir))


def carry_into_port(jloop, kw: dict) -> None:
    """Write the reference loop's initial state as the port's step-0
    checkpoint under ``kw["checkpoint_dir"]`` (tables by array name,
    the backbone through ``interop.backbone_params_from_flax``)."""
    import jax
    import torch

    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.interop import backbone_params_from_flax
    from tdfo_tpu_torch.train.trainer import Trainer

    tr = Trainer(read_configs(None, **kw), device="cpu")
    js = jloop.trainer.state
    with torch.no_grad():
        for name, t in tr.state.tables.items():
            t.copy_(torch.from_numpy(np.array(js.tables[name])))
        tr.state.backbone.load_state_dict(
            backbone_params_from_flax(jax.tree.map(np.asarray, js.dense_params)))
    tr._ckpt.save(0, tr.state, force=True, cursor=None, stamps=tr._ckpt_stamps)
    tr._ckpt.close()
    tr.close_telemetry()


def online_cycles(metrics: Path) -> list[dict]:
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    return [r for r in recs if r.get("event") == "online_cycle"]


def bundle_bytes(bundle_dir: Path) -> dict:
    """Manifest and stored arrays of a bundle, for a bitwise comparison."""
    from tdfo_tpu_torch.serve.export import read_raw_bundle

    manifest, arrays = read_raw_bundle(bundle_dir)
    return {"manifest": manifest,
            "arrays": {k: (str(v.dtype), v.shape, v.tobytes()) for k, v in arrays.items()}}


def spawn_port_worker(spec: dict, spec_path: Path) -> subprocess.Popen:
    """Run ``tests/torch_online_worker.py`` on ``spec`` (port only)."""
    spec_path.write_text(json.dumps(spec))
    env = os.environ.copy()
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).with_name("torch_online_worker.py")),
         str(spec_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env)
