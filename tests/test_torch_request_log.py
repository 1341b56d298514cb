"""The port's request log (``tdfo_tpu_torch/data/replay.py::RequestLog``),
trace sinks (``obs/trace.py``) and percentile (``obs/aggregate.py``)
against the reference's, on the CPU: the same records appended by both
writers leave byte-identical segments and seals (rotation, a reopen after
a seal, a torn tail truncated on reopen, and the three log faults
``truncate_log_at_byte``, ``dup_record_nth`` and ``corrupt_record_nth``);
the micro-batcher's logged records are the reference's; spans emitted by
both packages load back as the same records (timestamps aside), and
``percentile`` and ``assemble`` agree."""

import json

import numpy as np
import pytest

from tdfo_tpu.data import replay as jreplay
from tdfo_tpu.obs import aggregate as jagg
from tdfo_tpu.obs import trace as jtrace
from tdfo_tpu.utils import faults as jfaults
from tdfo_tpu_torch.data import replay as treplay
from tdfo_tpu_torch.obs import aggregate as tagg
from tdfo_tpu_torch.obs import trace as ttrace
from tdfo_tpu_torch.utils import faults as tfaults

PKGS = {"jax": (jreplay, jfaults), "port": (treplay, tfaults)}


@pytest.fixture(autouse=True)
def _clean():
    yield
    for mod in (jfaults, tfaults):
        mod.configure(None)
    for mod in (jtrace, ttrace):
        mod.configure(None)


def _records(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"event": "serve_request", "request": f"r{i}", "rows": 2,
             "outcome": "ok", "version": 1,
             "features": {"x": rng.integers(0, 9, 2).tolist(),
                          "y": rng.random(2).astype(np.float32).tolist()}}
            for i in range(n)]


def _files(root):
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())}


def _write_both(tmp_path, fn, faults=None):
    """Run ``fn(replay_module, root)`` for both packages (each with its own
    fault injector armed from ``faults``); their directories' files."""
    out = {}
    for name, (replay, fmod) in PKGS.items():
        if faults:
            fmod.configure(fmod.FaultSpec(**faults))
        root = tmp_path / name
        fn(replay, root)
        fmod.configure(None)
        out[name] = _files(root)
    return out


def _append(replay, root, recs, segment_bytes):
    log = replay.RequestLog(root, segment_bytes=segment_bytes)
    seqs = [log.append(r) for r in recs]
    log.close()
    return seqs


@pytest.mark.parametrize("segment_bytes", [0, 400, 1500])
def test_segments_and_seals_are_the_reference_bytes(tmp_path, segment_bytes):
    recs = _records(23)
    files = _write_both(tmp_path, lambda r, root: _append(r, root, recs,
                                                         segment_bytes))
    assert files["port"] == files["jax"]
    if segment_bytes:
        seals = [json.loads(v) for k, v in files["port"].items()
                 if k.endswith(".seal.json")]
        assert seals and all(s["records"] > 0 for s in seals)


def test_reopen_after_seal_and_force_seal_resume_seq(tmp_path):
    recs = _records(12, seed=1)

    def run(replay, root):
        log = replay.RequestLog(root, segment_bytes=700)
        for r in recs[:5]:
            log.append(r)
        log.seal_active()
        log.close()
        log = replay.RequestLog(root, segment_bytes=700)  # after a seal
        assert [log.append(r) for r in recs[5:]] == list(range(6, 13))
        log.close()

    files = _write_both(tmp_path, run)
    assert files["port"] == files["jax"]


def test_torn_tail_truncated_on_reopen(tmp_path):
    recs = _records(6, seed=2)

    def run(replay, root):
        _append(replay, root, recs[:4], 0)
        seg = root / "requests-000000.jsonl"
        seg.write_bytes(seg.read_bytes()[:-17])  # a crashed writer's tail
        log = replay.RequestLog(root)
        assert log.last_seq == 3
        assert [log.append(r) for r in recs[4:]] == [4, 5]
        log.close()

    files = _write_both(tmp_path, run)
    assert files["port"] == files["jax"]


@pytest.mark.parametrize("fault", [{"truncate_log_at_byte": 300},
                                   {"dup_record_nth": 3},
                                   {"corrupt_record_nth": 4}],
                         ids=["truncate", "dup", "corrupt"])
def test_log_faults_leave_the_reference_bytes(tmp_path, fault):
    recs = _records(8, seed=3)

    def run(replay, root):
        _append(replay, root, recs, 0)
        # the reopen after the fault (a torn tail is cut here)
        log = replay.RequestLog(root)
        log.append(recs[0])
        log.close()

    files = _write_both(tmp_path, run, faults=fault)
    assert files["port"] == files["jax"]
    body = files["port"]["requests-000000.jsonl"]
    if "dup_record_nth" in fault:
        seqs = [json.loads(x)["seq"] for x in body.splitlines()]
        assert seqs.count(3) == 2
    if "corrupt_record_nth" in fault:
        assert body.splitlines()[3].startswith(b"#")


def test_microbatcher_logs_the_reference_records(tmp_path):
    """The port's MicroBatcher with a request log: served and shed requests
    land as the reference batcher writes them (the ``label`` column logged
    and stripped before scoring), every field but the clock's."""
    from tdfo_tpu.serve.frontend import MicroBatcher as JMB
    from tdfo_tpu_torch.serve.frontend import MicroBatcher as TMB

    rng = np.random.default_rng(4)
    reqs = [(f"q{i}", {"x": rng.integers(0, 5, n).astype(np.int32),
                       "label": rng.integers(0, 2, n).astype(np.int8)})
            for i, n in enumerate([3, 1, 4, 2, 2])]
    seen = {}
    out = {}
    for name, (replay, _), mb in (("jax", PKGS["jax"], JMB),
                                  ("port", PKGS["port"], TMB)):
        t = {"now": 0.0}
        log = replay.RequestLog(tmp_path / name)

        def score(batch, _name=name):
            seen.setdefault(_name, []).append(sorted(batch))
            return batch["x"].astype(np.float32) * 2

        b = mb(score, buckets=(4, 8), max_batch=8, batch_deadline_ms=5.0,
               clock=lambda: t["now"], max_queue=2, shed_policy="reject",
               request_log=log)
        for rid, batch in reqs:
            b.submit(rid, batch)
            t["now"] += 0.001
        b.drain()
        log.close()
        out[name] = [{k: v for k, v in json.loads(x).items()
                      if k != "latency_ms"}
                     for x in (tmp_path / name / "requests-000000.jsonl")
                     .read_text().splitlines()]
    assert out["port"] == out["jax"]
    assert seen["port"] == seen["jax"] and ["x"] in seen["port"]
    assert any(r["outcome"] == "shed" and "features" not in r for r in out["port"])
    assert any("label" in r.get("features", {}) for r in out["port"])


def test_trace_spans_load_as_the_reference_spans(tmp_path):
    for name, tr in (("jax", jtrace), ("port", ttrace)):
        tr.configure(tmp_path / name)
        tr.emit("frontend", "serve_request", replica=0, seq=1, version=2)
        with tr.span("fleet", "replica_sync", replica=1) as extra:
            extra["digest"] = "abc"
        tr.emit("ingress", "ingress_request", replica=1, rid="r1",
                latency_ms=1.5, shed=False, queue_depth=0)
        tr.configure(None)
    # a torn tail of a live sink is skipped by both loaders
    with open(tmp_path / "port" / "trace-frontend.jsonl", "a") as f:
        f.write('{"span": 9, "ts"')

    def strip(spans):
        return [{k: v for k, v in s.items() if k not in ("ts", "dur_ms")}
                for s in spans]

    jspans = jagg.load_spans(tmp_path / "jax")
    tspans = tagg.load_spans(tmp_path / "port")
    assert sorted(map(json.dumps, strip(tspans))) == sorted(
        map(json.dumps, strip(jspans)))
    assert sorted(map(json.dumps, strip(jagg.load_spans(tmp_path / "port")))) == \
        sorted(map(json.dumps, strip(jspans)))
    for s in tspans:
        assert s["span"] in (1, 2, 3)
    report = tagg.assemble(tspans)
    want = jagg.assemble(jspans)
    assert report.keys() == want.keys()
    assert tagg.format_report(report).splitlines()[0] == \
        jagg.format_report(want).splitlines()[0]


def test_trace_off_writes_nothing_and_lines_stay_whole(tmp_path):
    ttrace.emit("frontend", "serve_request", seq=1)
    assert not ttrace.active() and list(tmp_path.iterdir()) == []
    ttrace.configure(tmp_path, rotate_bytes=400)
    for i in range(40):
        ttrace.emit("fleet", "heartbeat", replica=i % 2, ms=0.5 * i)
    ttrace.configure(None)
    names = {p.name for p in tmp_path.iterdir()}
    assert "trace-fleet.jsonl.1" in names
    assert names <= {"trace-fleet.jsonl", "trace-fleet.jsonl.1"}
    for p in tmp_path.iterdir():
        for line in p.read_text().splitlines():
            json.loads(line)  # every line whole


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_percentile_is_the_reference_percentile(seed):
    rng = np.random.default_rng(seed)
    samples = list(rng.exponential(3.0, int(rng.integers(1, 300))))
    for q in (0, 1, 50, 90, 99, 99.9, 100):
        assert tagg.percentile(samples, q) == jagg.percentile(samples, q)
    assert tagg.percentile([], 50) is jagg.percentile([], 50) is None
