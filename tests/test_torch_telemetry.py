"""The port's ``[telemetry]`` and training ``[faults]`` sites on the CPU:
``obs/counters.py``, ``obs/events.py``, the trainer's stall watchdog, and
the NaN, I/O-failure and kill triggers through ``Trainer.fit``.

* Counters are lazy and off the step's path: with no collector open,
  ``emit`` never calls its thunk, and a train step dispatches exactly the
  ATen operations it dispatches with every emit site removed (counted with
  a ``TorchDispatchMode``; sparse DMP, dense and update-cache steps).  With
  counters on the trajectory is bitwise the same (tables, slots, backbone,
  losses), and ``metrics.jsonl`` carries the per-table touched counts, the
  cache hit rate and the grad/param norms at the log cadence.
* Events keep the reference's ``events.jsonl`` schema: ``compile`` records
  (name, duration_s, per-name count, after_warmup), ``warmup_done``,
  ``run_summary`` last; builds after warm-up are flagged with the
  reference's warning; the memory sampler is None off the card.
* The faults reach the reference's outcomes
  (``tests/test_fault_tolerance.py``): an injected NaN rolls back to the
  step-2 snapshot with finite final metrics; ``fail_io_nth = 1`` is
  retried away into ``retries.jsonl``; ``kill_at_step = 5`` after the
  step-3 checkpoint resumes mid-epoch and ends bitwise on the
  uninterrupted run; an injected stall trips the training watchdog.
"""

import json
import logging
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tdfo_tpu_torch.core.config import read_configs
from tdfo_tpu_torch.obs import counters as C
from tdfo_tpu_torch.obs import events
from tdfo_tpu_torch.train.trainer import Trainer
from tdfo_tpu_torch.utils import faults, retry


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    faults.configure(None)
    retry.set_failure_log(None)
    events.configure(None)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from tdfo_tpu_torch.data.ctr_preprocessing import run_ctr_preprocessing
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads

    d = tmp_path_factory.mktemp("gr_tele")
    write_synthetic_goodreads(d, n_users=80, n_books=120,
                              interactions_per_user=(15, 40), seed=7)
    return str(d), run_ctr_preprocessing(d)


def _cfg(data, **kw):
    d, ctr = data
    return read_configs(
        None, data_dir=d, model="twotower", n_epochs=1, learning_rate=3e-3,
        embed_dim=8, per_device_train_batch_size=16,
        per_device_eval_batch_size=16, shuffle_buffer_size=500,
        log_every_n_steps=2, size_map=ctr, **kw)


# ---------------------------------------------------------------- counters


def test_emit_is_lazy_scoped_and_suppressible():
    calls = []

    def thunk():
        calls.append(1)
        return torch.tensor(3.0)

    assert not C.enabled()
    C.emit("x", thunk)
    assert not calls
    with C.collect() as c:
        C.emit("x", thunk)
        with C.scope("emb/c0/"):
            C.emit("touched", 5)
        with C.suppress():
            assert not C.enabled()
            C.emit("hidden", thunk)
        with C.collect() as inner:
            C.emit("b", 2)
    assert not C.enabled()
    assert {k: float(v) for k, v in c.items()} == {"x": 3.0, "emb/c0/touched": 5.0}
    assert set(inner) == {"b"} and len(calls) == 1
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in c.values())


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _step_ops(tr, batch):
    """The ATen ops one train step of ``tr`` dispatches (and its loss)."""
    with _Count() as m:
        tr.state, loss = tr._one_step(tr.state, batch)
    return m.ops, loss


def _batch(tr):
    """The first batch of the trainer's own stream."""
    return next(iter(tr._train_batches(0)))[0]


@pytest.mark.parametrize("extra", [
    dict(model_parallel=True),
    dict(model_parallel=False),
    dict(model_parallel=True, dedup_lookup=True, fused_table_threshold=0),
    dict(model_parallel=True, sparse_optimizer="rowwise_adagrad",
         fused_table_threshold=-1, embeddings={"cache_rows": 256, "flush_every": 2}),
], ids=["dmp", "dense", "dedup_fat", "cache"])
def test_counters_off_dispatch_no_op(data, monkeypatch, extra):
    """Counters off: the step dispatches exactly the ops it does with every
    emit site a no-op that never evaluates anything; on, it dispatches
    more (the counters are real computations)."""
    runs = {}
    for mode in ("off", "stripped", "on"):
        with monkeypatch.context() as mp:
            if mode == "stripped":
                mp.setattr(C, "emit", lambda name, value: None)
                mp.setattr(C, "enabled", lambda: False)
            tr = Trainer(_cfg(data, telemetry={"counters": mode == "on"}, **extra),
                         device="cpu")
            tr._train_auc = None
            runs[mode] = _step_ops(tr, _batch(tr))
    assert runs["off"][0] == runs["stripped"][0]
    assert len(runs["on"][0]) > len(runs["off"][0])
    assert torch.equal(runs["on"][1], runs["off"][1])


@pytest.mark.parametrize("extra", [
    dict(model_parallel=True),
    dict(model_parallel=True, sparse_optimizer="rowwise_adagrad",
         fused_table_threshold=-1, embeddings={"cache_rows": 512, "flush_every": 3}),
], ids=["dmp", "cache"])
def test_counters_do_not_change_trajectory(data, tmp_path, extra):
    trs = {}
    for on in (False, True):
        trs[on] = Trainer(_cfg(data, telemetry={"counters": on}, **extra),
                          log_dir=tmp_path / str(on), device="cpu")
        trs[on].fit()
    s0, s1 = (trs[k].state.state_dict() for k in (False, True))

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [t] if torch.is_tensor(t) else []
    for a, b in zip(leaves(s0), leaves(s1), strict=True):
        assert torch.equal(a, b)
    recs = [json.loads(line) for line in
            (tmp_path / "True" / "metrics.jsonl").read_text().splitlines()]
    off = [json.loads(line) for line in
           (tmp_path / "False" / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if "grad_norm" in r]
    assert steps and [r["train_loss"] for r in steps] == \
        [r["train_loss"] for r in off if "train_loss" in r and "step" in r]
    last = steps[-1]
    assert last["param_norm"] > 0 and last["grad_norm"] > 0
    assert last["nonfinite_logits"] == 0.0
    assert any(k.startswith("emb/") and k.endswith("touched_ids") for k in last)
    if "embeddings" in extra:
        rates = [r[k] for r in steps for k in r if k.endswith("cache_hit_rate")]
        assert rates and all(0.0 <= v <= 1.0 for v in rates)
        assert any(k.endswith("cache_flushed_rows") for r in steps for k in r)


# ------------------------------------------------------------------ events


def test_events_schema_and_warmup_warning(tmp_path, caplog):
    events.configure(tmp_path / "events.jsonl")
    events.compiled("kernel_build:segment_sum", 1.5)
    events.compiled("kernel_build:segment_sum", 0.5)
    assert events.compile_count("segment_sum") == 2 == events.compile_count()
    events.mark_warmup()
    with caplog.at_level(logging.WARNING, logger="tdfo_tpu_torch.obs.events"):
        events.compiled("serving_program:x[32]", 0.01)
    assert any("UNEXPECTED RETRACE" in r.getMessage() for r in caplog.records)
    assert events.memory_snapshot() is None  # no card
    events.record("run_summary", peak_bytes=events.peak_memory())
    ev = [json.loads(line) for line in (tmp_path / "events.jsonl").read_text().splitlines()]
    assert [e["kind"] for e in ev] == ["compile", "compile", "warmup_done",
                                        "compile", "run_summary"]
    for e in ev:
        if e["kind"] == "compile":
            assert set(e) == {"time", "kind", "name", "duration_s", "count",
                              "after_warmup"}
    assert [e["after_warmup"] for e in ev if e["kind"] == "compile"] == \
        [False, False, True]
    assert ev[1]["count"] == 2


def test_fit_records_events_and_scorer_programs(data, tmp_path):
    """A fit with events on: warm-up marked after the first epoch and eval,
    ``run_summary`` last and the recorder detached; then a scorer's new
    batch shapes are serving-program builds."""
    import numpy as np

    from tdfo_tpu_torch.serve.frontend import restore_and_export
    from tdfo_tpu_torch.serve.export import load_bundle
    from tdfo_tpu_torch.serve.scoring import make_scorer

    cfg = _cfg(data, model_parallel=True, checkpoint_dir=str(tmp_path / "ck"),
               telemetry={"events": True})
    Trainer(cfg, device="cpu").fit()
    ev = [json.loads(line) for line in
          (tmp_path / "ck" / "events.jsonl").read_text().splitlines()]
    assert ev[-1]["kind"] == "run_summary" and not events.active()
    assert any(e["kind"] == "warmup_done" for e in ev)
    tr, _, out_dir, cat, cont = restore_and_export(cfg, device="cpu")
    sc = make_scorer(load_bundle(out_dir), device="cpu")
    rng = np.random.default_rng(0)
    for n in (8, 8, 4):
        sc.score({**{c: np.zeros(n, np.int32) for c in cat},
                  **{c: rng.random(n, dtype=np.float32) for c in cont}})
    assert events.compile_count("serving_program") == 2
    tr.close_telemetry()
    ev = [json.loads(line) for line in
          (tmp_path / "ck" / "events.jsonl").read_text().splitlines()]
    assert [e["count"] for e in ev if e["kind"] == "compile"] == [1, 1]


# ------------------------------------------------------------------ faults


def test_stall_trips_the_training_watchdog(data, tmp_path, capsys):
    tr = Trainer(_cfg(data, model_parallel=True,
                      faults={"stall_at_step": 2, "stall_seconds": 1.0},
                      telemetry={"stall_timeout_s": 0.25}),
                 log_dir=tmp_path, device="cpu")
    assert np.isfinite(tr.fit()["eval_loss"])
    hb = [json.loads(line) for line in
          (tmp_path / "heartbeat.jsonl").read_text().splitlines()]
    steps = [r["last_step"] for r in hb if "stalled" in r]
    assert steps and steps == sorted(steps) and steps[-1] >= 2
    assert "[faults] injected 1.0s stall" in capsys.readouterr().out
    assert tr._watchdog.stall_events
    assert any(r.get("kind") == "stall" and "stacks" in r for r in hb)


def test_nan_rollback_end_to_end(data, tmp_path):
    tr = Trainer(_cfg(data, faults={"nan_at_step": 4}, nonfinite_tolerance=2,
                      snapshot_every_n_steps=2), log_dir=tmp_path, device="cpu")
    metrics = tr.fit()
    assert metrics and all(math.isfinite(v) for v in metrics.values())
    for p in tr.state.model.parameters():
        assert torch.isfinite(p).all()
    recs = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    rb = [r for r in recs if r.get("rollback")]
    assert rb and rb[0]["restored_to_step"] == 2 and rb[0]["skipped_steps"] >= 2
    assert not math.isfinite(rb[0]["nonfinite_loss"])
    assert math.isfinite([r for r in recs if "train_loss_epoch" in r][-1]["train_loss_epoch"])


def test_injected_io_failure_inside_training_run(data, tmp_path):
    metrics = Trainer(_cfg(data, faults={"fail_io_nth": 1}), log_dir=tmp_path,
                      device="cpu").fit()
    assert all(math.isfinite(v) for v in metrics.values())
    recs = [json.loads(line) for line in (tmp_path / "retries.jsonl").read_text().splitlines()]
    assert any("[faults] injected I/O failure" in r["error"] for r in recs)
    assert all(not r["final"] for r in recs)


def test_midepoch_kill_resume_bit_identical(data, tmp_path, monkeypatch):
    from tdfo_tpu_torch.train.checkpoint import CheckpointManager

    class Killed(SystemExit):
        pass

    def fake_exit(code):
        raise Killed(code)

    monkeypatch.setattr(faults.os, "_exit", fake_exit)
    base = dict(model_parallel=True, checkpoint_dir=str(tmp_path / "ckpt"),
                checkpoint_every_n_steps=3, faults={"kill_at_step": 5})
    with pytest.raises(Killed):
        Trainer(_cfg(data, **base), log_dir=tmp_path / "log1", device="cpu").fit()
    assert (tmp_path / "ckpt" / "faults_kill.marker").exists()
    mgr = CheckpointManager(tmp_path / "ckpt")
    cursor = mgr.read_cursor(mgr.latest_step())
    assert cursor is not None and not cursor["epoch_complete"]
    assert cursor["epoch"] == 0 and cursor["step"] == 3
    tr2 = Trainer(_cfg(data, **base), log_dir=tmp_path / "log2", device="cpu")
    m_resumed = tr2.fit()
    recs = [json.loads(line) for line in
            (tmp_path / "log2" / "metrics.jsonl").read_text().splitlines()]
    assert any(r.get("resumed_mid_epoch") == 0 and r.get("step") == 3 for r in recs)
    ref = dict(base, checkpoint_dir=str(tmp_path / "ckpt_ref"), faults={})
    tr_ref = Trainer(_cfg(data, **ref), log_dir=tmp_path / "log3", device="cpu")
    assert tr_ref.fit() == m_resumed
    a, b = tr2.state.state_dict(), tr_ref.state.state_dict()
    for name in a["tables"]:
        assert torch.equal(a["tables"][name], b["tables"][name])
    for name in a["backbone"]:
        assert torch.equal(a["backbone"][name], b["backbone"][name])
