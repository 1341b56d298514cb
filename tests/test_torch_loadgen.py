"""The port's load generator (``tdfo_tpu_torch/serve/loadgen.py``) against
``tdfo_tpu/serve/loadgen.py`` on the CPU: the same zipf request stream for
the same seed (ids, continuous columns and request ids, bitwise), the
closed loop's concurrency cap and the open loop's rate pacing under an
injected clock, and the knee sweep — each run through both packages'
``LoadGenerator`` on identical fake ingresses, with identical stats."""

import numpy as np
import pytest

from tdfo_tpu.serve import loadgen as jlg
from tdfo_tpu_torch.core.config import LoadgenSpec
from tdfo_tpu_torch.serve import loadgen as tlg

VOCAB = {"user_id": 500, "item_id": 260, "language": 8}
CONTS = ("avg_rating", "num_pages")


class FakeIngress:
    """The duck-typed submit/poll surface: one completion per poll at a
    fixed latency; every ``shed_every``-th completion is a shed; the
    high-water in-flight mark is kept."""

    def __init__(self, latency_ms=5.0, clock=None, shed_every=0):
        self.completed, self.latencies_ms = {}, []
        self.sheds = self.failures = 0
        self._queue, self._n = [], 0
        self._latency_ms, self._clock, self._shed_every = latency_ms, clock, shed_every
        self.max_inflight = 0
        self.submitted = []

    def submit(self, rid, feats):
        self._queue.append(rid)
        self.submitted.append((rid, {k: v.copy() for k, v in feats.items()}))
        self.max_inflight = max(self.max_inflight, len(self._queue))
        return 0

    def inflight(self):
        return len(self._queue)

    def poll(self, timeout_s=0.0):
        if self._clock is not None:
            self._clock["ms"] += 1.0  # a poll is the passage of time here
        if not self._queue:
            return 0
        rid = self._queue.pop(0)
        self._n += 1
        if self._shed_every and self._n % self._shed_every == 0:
            self.completed[rid] = None
            self.sheds += 1
        else:
            self.completed[rid] = np.zeros(1, np.float32)
            self.latencies_ms.append(self._latency_ms + (self._n % 3))
        return 1


def _spec(**kw):
    return LoadgenSpec(**kw)


def _both(spec, **ing_kw):
    """Both packages' generators on fresh identical fake ingresses (the
    reference's takes its own spec class; the fields are the same)."""
    from tdfo_tpu.core.config import LoadgenSpec as JSpec

    out = []
    for mod, sp in ((jlg, JSpec(**spec.__dict__)), (tlg, spec)):
        clock = {"ms": 0.0} if spec.mode == "open" else None
        ing = FakeIngress(clock=clock, **ing_kw)
        kw = {"elapsed_ms": lambda t0, c=clock: c["ms"]} if clock else {}
        out.append((mod.LoadGenerator(ing, sp, VOCAB, CONTS, **kw), ing, clock))
    return out


@pytest.mark.parametrize("seed,zipf_a,rows", [(606, 1.1, 4), (3, 2.0, 64), (9, 1.5, 1)])
def test_request_stream_is_the_reference_stream(seed, zipf_a, rows):
    (jg, _, _), (tg, _, _) = _both(_spec(seed=seed, zipf_a=zipf_a,
                                         rows_per_request=rows))
    for _ in range(20):
        jrid, jb = jg.request()
        trid, tb = tg.request()
        assert trid == jrid and sorted(tb) == sorted(jb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype and tb[k].tobytes() == jb[k].tobytes()
        for c, v in VOCAB.items():
            assert 0 <= tb[c].min() and tb[c].max() < v


def test_closed_loop_respects_concurrency_as_the_reference():
    spec = _spec(mode="closed", requests=25, concurrency=3, rows_per_request=2,
                 p99_slo_ms=50.0)
    (jg, jing, _), (tg, ting, _) = _both(spec, shed_every=7)
    js, ts = jg.run(), tg.run()
    assert {k: v for k, v in ts.items() if k != "achieved_qps"} == \
        {k: v for k, v in js.items() if k != "achieved_qps"}
    assert ts["completed"] == 25 and ts["shed"] == 3 and ts["failed"] == 0
    assert ting.max_inflight == jing.max_inflight <= 3
    assert [r for r, _ in ting.submitted] == [r for r, _ in jing.submitted]


def test_open_loop_paces_by_rate_as_the_reference():
    spec = _spec(mode="open", requests=8, rate_qps=100.0, rows_per_request=2,
                 p99_slo_ms=50.0)
    (jg, _, jclock), (tg, _, tclock) = _both(spec)
    js, ts = jg.run(), tg.run()
    assert ts == js
    assert ts["offered_qps"] == 100.0 and ts["concurrency"] is None
    assert ts["completed"] == 8
    # 8 arrivals 10 ms apart: the schedule, not the service times, sets it
    assert tclock["ms"] == jclock["ms"] >= 70.0


@pytest.mark.parametrize("mode", ["closed", "open"])
def test_knee_sweeps_as_the_reference(mode):
    spec = _spec(mode=mode, requests=6, rows_per_request=2, rate_qps=80.0,
                 p99_slo_ms=6.5)
    (jg, _, _), (tg, _, _) = _both(spec)
    jr, tr = jg.knee(steps=3), tg.knee(steps=3)

    def clockless(rep):
        return [{k: v for k, v in s.items() if k != "achieved_qps"}
                for s in rep["steps"]]

    assert clockless(tr) == clockless(jr)
    if mode == "closed":
        assert [s["concurrency"] for s in tr["steps"]] == [1, 2, 4]
    else:
        assert [s["offered_qps"] for s in tr["steps"]] == [20.0, 40.0, 80.0]
    assert (tr["knee"] is None) == (jr["knee"] is None)


# ------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def goodreads(tmp_path_factory):
    import json

    from tdfo_tpu_torch import launch

    tmp = tmp_path_factory.mktemp("fleet_cli")
    body = {"data_dir": str(tmp / "data"), "model": "twotower",
            "model_parallel": True, "embed_dim": 16, "fused_table_threshold": 0}
    lines = [f"{k} = {json.dumps(v) if not isinstance(v, bool) else str(v).lower()}"
             for k, v in body.items()]
    (tmp / "base.toml").write_text("\n".join(lines) + "\n")
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads

    write_synthetic_goodreads(tmp / "data", n_users=200)
    assert launch.main(["preprocess-ctr", "--config", str(tmp / "base.toml")]) == 0
    return tmp


def _toml(tmp, name, tables: str):
    path = tmp / name
    path.write_text((tmp / "base.toml").read_text() + tables)
    return path


FLEET_KEYS = {"requests", "batches", "p50_ms", "p99_ms", "shed", "swaps",
              "replicas", "version", "qps", "bundle", "step", "retrieved"}


def test_launch_serve_fleet_and_loadgen_on_cpu(goodreads, tmp_path):
    """``launch serve-fleet`` and ``launch loadgen`` with ``--device cpu``:
    two replica processes on the CPU answer the 64-request trace, then a
    two-step closed-loop knee; the reference's stats and report keys."""
    import math

    from tdfo_tpu_torch import launch

    cfg = _toml(goodreads, "fleet.toml", "[serving]\nreplicas = 2\n"
                "[loadgen]\nrequests = 12\np99_slo_ms = 60000.0\n")
    stats = launch.run(["serve-fleet", "--config", str(cfg), "--device", "cpu",
                        "--log-dir", str(tmp_path / "a")])
    assert set(stats) == {"requests", "answered", "p50_ms", "p99_ms", "shed",
                          "failed", "replicas", "version", "qps", "bundle", "step"}
    assert stats["requests"] == stats["answered"] == 64 and stats["replicas"] == 2
    assert stats["failed"] == 0 and math.isfinite(stats["p99_ms"])
    report = launch.run(["loadgen", "--config", str(cfg), "--device", "cpu",
                         "--knee-steps", "2", "--log-dir", str(tmp_path / "b")])
    assert [s["concurrency"] for s in report["steps"]] == [1, 2]
    assert all(s["completed"] == 12 and s["failed"] == 0 for s in report["steps"])
    assert report["knee"] is not None and report["replicas"] == 2


@pytest.mark.parametrize("replicas", [1, 2])
def test_launch_serve_with_request_log_and_watchdog(goodreads, tmp_path, replicas):
    """``launch serve`` with ``log_features`` and (one frontend) the serving
    watchdog, or ``replicas = 2`` (the in-process fleet over a bundle
    store): each replica's request log holds the served requests, labels
    included; the watchdog's heartbeats land beside them."""
    import json

    from tdfo_tpu_torch import launch

    cfg = _toml(goodreads, f"log{replicas}.toml",
                f"[serving]\nreplicas = {replicas}\nlog_features = true\n"
                "[telemetry]\nstall_timeout_s = 30.0\n")
    stats = launch.run(["serve", "--config", str(cfg), "--device", "cpu",
                        "--log-dir", str(tmp_path)])
    root = tmp_path / "request_log"
    assert stats["request_log"] == str(root)
    dirs = [root / f"replica-{k}" for k in range(replicas)] if replicas > 1 else [root]
    recs = [json.loads(x) for d in dirs
            for x in (d / "requests-000000.jsonl").read_text().splitlines()]
    served = [r for r in recs if r["event"] == "serve_request"]
    assert len(served) == 64 and all("label" in r["features"] for r in served)
    if replicas > 1:
        assert set(stats) == FLEET_KEYS | {"request_log"} and stats["replicas"] == 2
        assert (tmp_path / "bundle_store" / "CURRENT").is_file()
    else:
        assert (tmp_path / "heartbeat_serve.jsonl").is_file()
