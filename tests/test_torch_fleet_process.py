"""The port's process fleet (``tdfo_tpu_torch/serve/{ingress,supervisor,
replica_main}.py``) on the CPU:

* the ingress's power-of-two-choices and staleness eviction, with injected
  clocks and draws, pick what the reference's ingress picks; score replies
  folded by ``rpc``, and requests in flight on a dropped connection failed
  and counted, as the reference does;
* the supervisor's respawn backoff and flap quarantine (injected popen,
  clock, sleep and draws) follow the reference's schedule bit for bit, and
  the real spawn pre-binds the listener and passes it by fd;
* a replica process asked for a device it cannot reach exits non-zero and
  never falls back to the CPU;
* one real drill: a fleet of 2 replica processes on the CPU, one SIGKILLed
  mid-trace, respawned onto the same version; every answered score equals
  the in-process fleet's, and the unanswered are counted as failures.
"""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_serve_helpers import ctr_batch, jax_twotower, port_twotower, twotower_export_kw

from tdfo_tpu.serve import ingress as jingress
from tdfo_tpu.serve import supervisor as jsup
from tdfo_tpu_torch.serve import ingress as tingress
from tdfo_tpu_torch.serve import supervisor as tsup
from tdfo_tpu_torch.serve import wire
from tdfo_tpu_torch.utils import faults as tfaults
from tdfo_tpu_torch.utils.retry import backoff_delay

REPO = str(Path(__file__).resolve().parents[1])


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    tfaults.configure(None)


class _Recorder:
    def __init__(self):
        self.events = []

    def log(self, **kw):
        self.events.append(kw)


def _ingress(mod, stale_ms, clock, seed=0, **kw):
    return mod.Ingress({}, stale_ms=stale_ms, rng=random.Random(seed),
                       elapsed_ms=lambda t0: clock["now"] - t0, **kw)


def test_p2c_and_stale_eviction_pick_as_the_reference(monkeypatch):
    """Four replicas with drawn loads, observed at injected times; both
    ingresses pick the same replica at every draw, evict the same stale
    ones, and refuse an all-stale fleet with the same words."""
    picks = {}
    for name, mod in (("jax", jingress), ("port", tingress)):
        clock = {"now": 0.0}
        monkeypatch.setattr(mod._trace, "clock", lambda c=clock: c["now"])
        ing = _ingress(mod, 100.0, clock, seed=11)
        rng = np.random.default_rng(2)
        out = []
        for k in range(4):
            ing._conns[k] = object()
        for t in range(60):
            clock["now"] = float(t * 10)
            k = int(rng.integers(0, 4))
            if t % 7 != 3 or k != 2:  # replica 2 goes quiet now and then
                ing.observe(k, {"queue_depth": int(rng.integers(0, 4)),
                                "batch_fill": float(rng.random())})
            try:
                out.append((ing.fresh(), ing.pick()))
            except RuntimeError as e:
                out.append(str(e))
        clock["now"] = 1e6
        with pytest.raises(RuntimeError, match="no fresh replica") as e:
            ing.pick()
        out.append(str(e.value))
        picks[name] = out
    assert picks["port"] == picks["jax"]
    assert len({p[1] for p in picks["port"] if isinstance(p, tuple)}) > 1


def test_rpc_folds_replies_and_disconnect_fails_inflight():
    import socket

    results = {}
    for name, mod in (("jax", jingress), ("port", tingress)):
        ours, theirs = socket.socketpair()
        log = _Recorder()
        ing = mod.Ingress({}, stale_ms=1e9, rng=random.Random(0),
                          elapsed_ms=lambda t0: t0, logger=log)
        ing._conns[0] = ours
        ing._inflight.update({"r9": (0, 123.0), "r10": (0, 5.0), "r11": (0, 1.0)})
        wire.send_msg(theirs, {"type": "reply", "rid": "r9", "scores": [0.5, 2.0],
                               "queue_depth": 3, "batch_fill": 0.75})
        wire.send_msg(theirs, {"type": "reply", "rid": "r10", "scores": None,
                               "queue_depth": 2, "batch_fill": 0.5})
        wire.send_msg(theirs, {"type": "drained", "replica": 0})
        reply = ing.rpc(0, {"type": "drain"})
        assert wire.recv_msg(theirs) == {"type": "drain"}
        ing.disconnect(0)  # r11 was still in flight
        theirs.close()
        results[name] = (reply, {k: None if v is None else v.tolist()
                                 for k, v in ing.completed.items()},
                         ing.sheds, ing.failures, ing.latencies_ms, log.events)
    assert results["port"] == results["jax"]
    assert results["port"][1] == {"r9": [0.5, 2.0], "r10": None, "r11": None}
    assert results["port"][2:4] == (1, 1)


class _FakeProc:
    def __init__(self, pid):
        self.pid, self.returncode = pid, None

    def poll(self):
        return self.returncode


def _fake(mod, **kw):
    spawned, slept, clock = [], [], {"t": 0.0}

    def popen(spec_path):
        spawned.append(_FakeProc(1000 + len(spawned)))
        return spawned[-1]

    sup = mod.ProcessSupervisor({0: "/dev/null", 1: "/dev/null"},
                                sleep=slept.append, clock=lambda: clock["t"],
                                rng=random.Random(7), popen=popen, **kw)
    return sup, spawned, slept, clock


@pytest.mark.parametrize("window_s,deaths", [(30.0, 3), (1.0, 2)])
def test_supervisor_backoff_and_flap_quarantine_as_the_reference(window_s, deaths):
    runs = {}
    for name, mod in (("jax", jsup), ("port", tsup)):
        log = _Recorder()
        sup, spawned, slept, clock = _fake(
            mod, respawn_base_ms=50.0, respawn_max_ms=400.0, flap_window_s=window_s,
            flap_max_deaths=deaths, logger=log)
        sup.spawn_all()
        trail = []
        for t in (1.0, 1.5, 2.0, 9.0, 9.2):
            victim = [p for p in spawned if p.returncode is None][0]
            victim.returncode = -9
            clock["t"] = t
            trail.append((sup.check(), sorted(sup.quarantined), dict(sup.respawns)))
            if t == 2.0:
                sup.mark_healthy(1)
        runs[name] = (trail, slept, [e["event"] for e in log.events])
    assert runs["port"] == runs["jax"]
    assert runs["port"][2].count("replica_quarantined") >= 1
    # the schedule is the one backoff law, drawn from the injected rng
    ref = random.Random(7)
    first = backoff_delay(0, base_delay=0.050, max_delay=0.400, rng=ref)
    assert runs["port"][1][0] == first


def test_spawn_prebinds_the_listener_and_sets_the_package_path(tmp_path, monkeypatch):
    """The real spawn path with ``Popen`` faked: the socket accepts a
    connection before any child exists, the fd rides ``--listen-fd`` +
    ``pass_fds``, stdio goes to the replica's log, and the child finds the
    package on ``PYTHONPATH`` wherever it starts."""
    import subprocess as sp

    sock = tmp_path / "replica-0.sock"
    spec = tmp_path / "replica-0.json"
    spec.write_text(json.dumps({"replica_id": 0, "socket": str(sock)}))
    calls, inherited = [], []

    def fake_popen(argv, **kw):
        inherited.extend(os.dup(fd) for fd in kw.get("pass_fds", ()))
        calls.append((argv, kw))
        return _FakeProc(4242)

    monkeypatch.setattr(sp, "Popen", fake_popen)
    tsup.ProcessSupervisor._spawn_child(spec)
    (argv, kw), = calls
    assert argv[1:3] == ["-m", "tdfo_tpu_torch.serve.replica_main"]
    fd = int(argv[argv.index("--listen-fd") + 1])
    assert kw["pass_fds"] == (fd,) and kw["stdin"] is sp.DEVNULL
    assert kw["stdout"].name == str(tmp_path / "replica-0.log")
    assert kw["env"]["PYTHONPATH"].split(os.pathsep)[0] == REPO
    client = wire.connect(sock, attempts=1)
    adopted = wire.listener_from_fd(inherited.pop())
    try:
        conn, _ = adopted.accept()
        wire.send_msg(conn, {"type": "synced"})
        assert wire.recv_msg(client) == {"type": "synced"}
        conn.close()
    finally:
        client.close()
        adopted.close()


def test_replica_without_its_device_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the child would reach it")
    spec = tmp_path / "replica-0.json"
    spec.write_text(json.dumps({"replica_id": 0, "socket": str(tmp_path / "r.sock"),
                                "store_dir": str(tmp_path / "store"),
                                "serving": {"buckets": [8]}}))  # device: "cuda"
    res = subprocess.run([sys.executable, "-m", "tdfo_tpu_torch.serve.replica_main",
                          str(spec)], capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": REPO, "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0
    assert "torch.cuda.is_available() is false" in res.stderr


def test_sigkill_drill_on_cpu_replicas(tmp_path):
    """2 replica processes on the CPU behind the ingress: replica 0 is
    SIGKILLed (``kill_replica_signal = 1``) halfway through a trace; the
    supervisor respawns it onto the same version; every answered score
    equals the in-process fleet's (rtol 1e-5), the lost ones are counted
    failures, and after the respawn both replicas answer the probe
    bitwise alike."""
    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.serve import export as texp
    from tdfo_tpu_torch.serve.fleet import ServingFleet
    from tdfo_tpu_torch.serve.swap import BundleStore

    _, _, jt, jd = jax_twotower(fused_threshold=200, seed=7)
    tc, tt, tb = port_twotower({k: np.asarray(v) for k, v in jt.items()},
                               jd, fused_threshold=200)
    v0 = texp.export_bundle(tmp_path / "v0", coll=tc, tables=tt, dense_params=tb,
                            **twotower_export_kw())
    store = BundleStore(tmp_path / "store")
    store.ingest_full(v0)
    cfg = read_configs(None, model="twotower", serving={
        "replicas": 2, "buckets": [8, 32], "max_batch": 32, "batch_deadline_ms": 0.0})
    rng = np.random.default_rng(9)
    trace = [(f"q{i}", ctr_batch(rng, int(rng.integers(1, 30)))) for i in range(24)]
    inproc = ServingFleet(store, cfg, device="cpu")
    inproc.sync()
    want = inproc.run(trace)
    tfaults.configure(tfaults.FaultSpec(kill_replica_signal=1))
    fleet = tsup.ProcessFleet(store, cfg, workdir=tmp_path / "pf", device="cpu")
    try:
        assert fleet.sync() == {0: 0, 1: 0}
        ing = fleet.ingress
        for rid, batch in trace[:12]:
            ing.submit(rid, batch)
            ing.poll(0.0)
        pid0 = fleet.supervisor.pid(0)
        fleet.mark_canary_watch()  # the SIGKILL
        for rid, batch in trace[12:]:
            ing.submit(rid, batch)
            ing.poll(0.0)
        assert fleet.sync() == {0: 0, 1: 0}  # respawned, re-followed
        assert fleet.supervisor.respawns[0] == 1
        assert fleet.supervisor.pid(0) != pid0
        for k in fleet.alive_ids():
            ing.rpc(k, {"type": "drain"})
        while ing.inflight() and ing.poll(1.0):
            pass
        answered = {r: ing.completed[r] for r, _ in trace
                    if ing.completed.get(r) is not None}
        assert len(trace) - len(answered) == ing.failures + ing.sheds
        assert len(answered) >= 12
        for rid, got in answered.items():
            np.testing.assert_allclose(got, want[rid], rtol=1e-5, atol=1e-6)
        probe = fleet.probe_each(trace[:4])
        assert sorted(probe) == [0, 1]
        for rid, _ in trace[:4]:
            assert np.array_equal(probe[0][rid], probe[1][rid])
            np.testing.assert_allclose(probe[0][rid], want[rid], rtol=1e-5, atol=1e-6)
    finally:
        fleet.close()
        inproc.close()
    logs = sorted(p.name for p in (tmp_path / "pf" / "fleet").glob("replica-*.log"))
    assert logs == ["replica-0.log", "replica-1.log"]
