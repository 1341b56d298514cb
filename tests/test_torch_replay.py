"""The port's request-log readers (``tdfo_tpu_torch/data/replay.py``:
``ReplayConsumer``, ``MergedReplayConsumer``, ``make_replay_consumer``)
against ``tdfo_tpu/data/replay.py`` on the CPU.

Each case writes one log with the port's ``RequestLog`` (its segments and
seals are byte-identical to the reference writer's,
``test_torch_request_log.py``), copies the directory, and runs the same
script of reads on the reference's consumer over one copy and the port's
over the other.  Everything the script observes must be EXACTLY equal
(tolerance: none — this is host data): every batch's columns (values and
dtypes), the consumed ``(seq, row_start, row_end)`` spans (``(replica,
seq, ...)`` when merged), cursors, ``counters()``, ``lag()``, the segments
a GC deleted, and every refusal's exception type and message.  The script
also checks the reader contract outright (the reference's test
expectations), so a shared defect cannot pass as agreement.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from tdfo_tpu.data import replay as jrep
from tdfo_tpu.utils import faults as jfaults
from tdfo_tpu_torch.data import replay as trep
from tdfo_tpu_torch.utils import faults as tfaults

SCHEMA = {"x": (np.int32, ()), "y": (np.float32, ()), "label": (np.int8, ())}


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    jfaults.configure(None)
    tfaults.configure(None)


def _record(rows: int, x0: int = 0) -> dict:
    return {"event": "serve_request", "request": f"r{x0}", "rows": rows,
            "outcome": "ok",
            "features": {"x": list(range(x0, x0 + rows)),
                         "y": [0.5] * rows, "label": [1] * rows}}


def _write(root: Path, n_records: int, rows: int = 3, segment_bytes: int = 0,
           close: bool = True):
    log = trep.RequestLog(root, segment_bytes=segment_bytes)
    for i in range(n_records):
        log.append(_record(rows, x0=i * rows))
    if close:
        log.close()
    return log


def _write_fleet(root: Path, n_records: int = 6, rows: int = 3,
                 segment_bytes: int = 0) -> None:
    for rid, base in ((0, 0), (1, 1000)):
        log = trep.RequestLog(trep.replica_log_dir(root, rid),
                              segment_bytes=segment_bytes)
        for i in range(n_records):
            log.append(_record(rows, x0=base + i * rows))
        log.close()


class Obs:
    """The observation log of one script run."""

    def __init__(self, root):
        self.items: list = []
        self.root = str(root)

    def batch(self, out):
        if out is None:
            self.items.append(None)
            return None
        batch, consumed = out
        self.items.append(({k: (str(v.dtype), v.tolist()) for k, v in batch.items()},
                           [list(map(int, c)) for c in consumed]))
        return out

    def state(self, c):
        self.items.append((json.loads(json.dumps(c.cursor())), c.counters(),
                           c.lag()))

    def call(self, fn, *a, **kw):
        try:
            out = fn(*a, **kw)
        except (ValueError, RuntimeError, SystemExit) as e:
            self.items.append((type(e).__name__,
                               str(e).replace(self.root, "<root>")))
            return None
        if isinstance(out, tuple):  # a batch
            self.batch(out)
        else:
            self.items.append(("ok", out if not isinstance(out, list) else
                               [list(o) if isinstance(o, tuple) else o for o in out]))
        return out

    def drain(self, c):
        xs = []
        while True:
            out = self.batch(c.next_batch())
            if out is None:
                return xs
            assert out[1] and all(s[-1] > s[-2] for s in out[1])
            xs += out[0]["x"].tolist() if "x" in out[0] else [len(out[1])]


def _twin(tmp_path, build, script):
    """Build the log once, copy it, run ``script(mod, root, obs)`` with each
    package's replay module on its own copy; the observations must be
    equal.  Returns the port's script result."""
    root = tmp_path / "t"
    build(root)
    shutil.copytree(root, tmp_path / "j")
    oj, ot = Obs(tmp_path / "j"), Obs(root)
    script(jrep, tmp_path / "j", oj)
    res = script(trep, root, ot)
    assert ot.items == oj.items
    return res


def _drain_flat(bsz, **kw):
    def script(m, root, o):
        c = m.ReplayConsumer(root, schema=SCHEMA, batch_size=bsz, **kw)
        xs = o.drain(c)
        o.state(c)
        return xs, c
    return script


# ------------------------------------------------------------- plain reads


def test_roundtrip_exact_batches(tmp_path):
    xs, c = _twin(tmp_path, lambda r: _write(r, 10, rows=3), _drain_flat(6))
    assert xs == list(range(30))
    assert c.cursor()["records"] == 10 and c.counters()["replay/lag"] == 0.0


def test_partial_batch_never_commits(tmp_path):
    def script(m, root, o):
        c = m.ReplayConsumer(root, schema=SCHEMA, batch_size=4)
        o.batch(c.next_batch())
        before = c.cursor()
        assert o.batch(c.next_batch()) is None
        assert c.cursor() == before
        o.state(c)
    _twin(tmp_path, lambda r: _write(r, 2, rows=3), script)


def test_mid_record_cursor_resume(tmp_path):
    def script(m, root, o):
        c1 = m.ReplayConsumer(root, schema=SCHEMA, batch_size=3)
        first = o.batch(c1.next_batch())[0]
        saved = c1.cursor()
        o.state(c1)
        c2 = m.ReplayConsumer(root, schema=SCHEMA, batch_size=3, cursor=saved)
        xs = first["x"].tolist() + o.drain(c2)
        assert saved["row"] == 3 and xs == list(range(18))
        o.state(c2)
    _twin(tmp_path, lambda r: _write(r, 4, rows=5), script)


def test_construction_refusals(tmp_path):
    def script(m, root, o):
        o.call(m.ReplayConsumer, root, schema=SCHEMA, batch_size=4,
               cursor={"segment": 0, "bogus": 1})
        o.call(lambda: m.ReplayConsumer(root, schema={"s": (np.int32, (16,))},
                                        batch_size=4).cursor())
        o.call(m.ReplayConsumer, root, schema={"m": (np.int32, (2, 3))},
               batch_size=4)
        o.call(m.ReplayConsumer, root, schema={"z": (np.int32, (0,))},
               batch_size=4)
        o.call(m.ReplayConsumer, root, schema=SCHEMA, batch_size=4,
               lag_policy="later")
    _twin(tmp_path, lambda r: r.mkdir(), script)


def test_vector_columns_batch_per_row(tmp_path):
    """Fixed-width per-row vectors (the seq family's ``seqs``/``cands``)."""
    def build(root):
        log = trep.RequestLog(root)
        rng = np.random.default_rng(0)
        for i in range(5):
            n = int(rng.integers(1, 4))
            log.append({"event": "serve_request", "request": f"s{i}", "rows": n,
                        "outcome": "ok", "features": {
                            "seqs": rng.integers(0, 50, (n, 6)).tolist(),
                            "cands": rng.integers(1, 50, (n, 4)).tolist()}})
        log.close()

    def script(m, root, o):
        c = m.ReplayConsumer(root, schema={"seqs": (np.int32, (6,)),
                                           "cands": (np.int32, (4,))},
                             batch_size=3)
        o.drain(c)
        o.state(c)
    _twin(tmp_path, build, script)


# ---------------------------------------------------------------- rotation


def test_rotation_boundary_crossing_reads(tmp_path):
    def build(root):
        log = _write(root, 12, rows=3, segment_bytes=256, close=False)
        assert log.active_segment >= 2
        log.close()
    xs, _ = _twin(tmp_path, build, _drain_flat(6))
    assert xs == list(range(36))


def test_writer_reopen_after_seal(tmp_path):
    def build(root):
        log = _write(root, 4, rows=2, close=False)
        log.seal_active()
        last = log.last_seq
        log.close()
        log2 = trep.RequestLog(root)
        assert log2.append(_record(2, x0=8)) == last + 1
        log2.close()
    xs, _ = _twin(tmp_path, build, _drain_flat(2))
    assert xs == list(range(10))


def test_torn_tail_waits_then_continues(tmp_path):
    def build(root):
        _write(root, 3, rows=2)
        with open(root / "requests-000000.jsonl", "ab") as f:
            f.write(b'{"seq": 99, "torn')

    def script(m, root, o):
        c = m.ReplayConsumer(root, schema=SCHEMA, batch_size=2)
        assert o.drain(c) == list(range(6))
        o.state(c)
        log2 = trep.RequestLog(root)  # recovery truncates the tear
        log2.append(_record(2, x0=6))
        log2.close()
        assert o.drain(c) == [6, 7]
        o.state(c)
    _twin(tmp_path, build, script)


# ---------------------------------------------------------- fault triggers


def test_truncate_fault_torn_tail_recovery(tmp_path):
    def build(root):
        log = _write(root, 2, rows=2, close=False)
        size = (root / "requests-000000.jsonl").stat().st_size
        tfaults.configure(tfaults.FaultSpec(truncate_log_at_byte=size + 7),
                          workdir=tmp_path / "f")
        log.append(_record(2, x0=4))
        log.close()
        tfaults.configure(None)

    def script(m, root, o):
        c = m.ReplayConsumer(root, schema=SCHEMA, batch_size=2)
        assert o.drain(c) == list(range(4))
        log2 = trep.RequestLog(root)
        log2.append(_record(2, x0=4))
        log2.close()
        assert o.drain(c) == [4, 5]
        o.state(c)
    _twin(tmp_path, build, script)


@pytest.mark.parametrize("spec,budget", [
    ({"dup_record_nth": 2}, 0),
    ({"corrupt_record_nth": 2}, 1),
    ({"corrupt_record_nth": 1}, 0),
], ids=["dup", "corrupt_quarantined", "corrupt_over_budget"])
def test_log_fault_records(tmp_path, spec, budget):
    def build(root):
        tfaults.configure(tfaults.FaultSpec(**spec), workdir=tmp_path / "f")
        _write(root, 4, rows=2)
        tfaults.configure(None)

    def script(m, root, o):
        c = m.ReplayConsumer(root, schema=SCHEMA, batch_size=2,
                             max_bad_records=budget)
        xs = []
        while True:
            out = o.call(c.next_batch)
            if out is None:
                break
            xs += out[0]["x"].tolist()
        o.state(c)
        return xs, c
    xs, c = _twin(tmp_path, build, script)
    if "dup_record_nth" in spec:
        assert xs == list(range(8)) and c.cursor()["dup"] == 1
    elif budget:
        assert xs == [0, 1, 4, 5, 6, 7] and c.cursor()["bad"] == 1
    else:
        assert xs == []


def test_kill_during_replay_fires_after_commit(tmp_path, monkeypatch):
    def fake_exit(code):
        raise SystemExit(code)

    monkeypatch.setattr(jfaults.os, "_exit", fake_exit)
    monkeypatch.setattr(tfaults.os, "_exit", fake_exit)

    def script(m, root, o):
        f = jfaults if m is jrep else tfaults
        work = root.parent / f"work_{root.name}"
        f.configure(f.FaultSpec(kill_during_replay=2), workdir=work)
        c = m.ReplayConsumer(root, schema=SCHEMA, batch_size=2)
        o.batch(c.next_batch())
        o.call(c.next_batch)  # record 2 commits, then the kill
        o.state(c)
        assert (work / "faults_replay_kill.marker").exists()
        c2 = m.ReplayConsumer(root, schema=SCHEMA, batch_size=2,
                              cursor=c.cursor())
        assert o.drain(c2) == list(range(4, 8))
        f.configure(None)
    _twin(tmp_path, lambda r: _write(r, 4, rows=2), script)


# ------------------------------------------------------------------ damage


def _flip_first_segment(root):
    seg = root / "requests-000000.jsonl"
    data = bytearray(seg.read_bytes())
    data[5] ^= 0x40
    seg.write_bytes(bytes(data))


def _drop_first_seal(root):
    os.unlink(sorted(root.glob("*.seal.json"))[0])


@pytest.mark.parametrize("damage,n", [(_flip_first_segment, 6),
                                      (_drop_first_seal, 8)],
                         ids=["digest_mismatch", "unsealed_with_successor"])
def test_chain_damage_refused(tmp_path, damage, n):
    def build(root):
        _write(root, n, rows=2, segment_bytes=128)
        damage(root)

    def script(m, root, o):
        c = m.ReplayConsumer(root, schema=SCHEMA, batch_size=2)
        o.call(c.next_batch)
        o.call(c.lag)
    _twin(tmp_path, build, script)


def test_schema_violations_quarantined(tmp_path):
    def build(root):
        log = trep.RequestLog(root)
        log.append(_record(2, x0=0))
        bad = _record(2, x0=2)
        bad["features"]["x"] = [2]
        log.append(bad)
        log.append(_record(2, x0=4))
        cast = _record(2, x0=6)
        cast["features"]["x"] = ["a", "b"]
        log.append(cast)
        log.append({"event": "serve_request", "rows": 2, "outcome": "ok",
                    "features": [1, 2]})
        log.append(_record(2, x0=8))
        log.close()
        seg = root / "requests-000000.jsonl"
        lines = seg.read_bytes().splitlines()
        rec = json.loads(lines[2])
        rec["schema_version"] = trep.REPLAY_SCHEMA_VERSION + 1
        lines[2] = json.dumps(rec).encode()
        seg.write_bytes(b"\n".join(lines) + b"\n")

    xs, c = _twin(tmp_path, build, _drain_flat(2, max_bad_records=4))
    assert xs == [0, 1, 8, 9] and c.cursor()["bad"] == 4


def test_shed_and_swap_records_are_skipped(tmp_path):
    def build(root):
        log = trep.RequestLog(root)
        log.append(_record(2, x0=0))
        log.append({"event": "serve_request", "request": "s", "rows": 3,
                    "outcome": "shed", "shed_reason": "displaced"})
        log.append({"event": "serve_swap", "version": 1, "from_version": 0})
        log.append(_record(2, x0=2))
        log.close()
    xs, c = _twin(tmp_path, build, _drain_flat(4))
    assert xs == [0, 1, 2, 3] and c.cursor()["skipped"] == 2


# ------------------------------------------------------------ backpressure


@pytest.mark.parametrize("policy,bound", [("fail", 3), ("skip", 3),
                                          ("fail", 8)])
def test_backpressure(tmp_path, policy, bound):
    def script(m, root, o):
        c = m.ReplayConsumer(root, schema=SCHEMA, batch_size=2,
                             max_lag_records=bound, lag_policy=policy)
        o.call(c.check_backpressure)
        o.state(c)
        xs = o.drain(c)
        o.state(c)
        return xs
    xs = _twin(tmp_path, lambda r: _write(r, 6, rows=2), script)
    assert xs == (list(range(6, 12)) if policy == "skip" else list(range(12)))


# ------------------------------------------------------ peek and retention


@pytest.mark.parametrize("n_records,n_peek", [(6, 2), (2, 3)])
def test_peek_batches_commits_nothing(tmp_path, n_records, n_peek):
    def script(m, root, o):
        c = m.ReplayConsumer(root, schema=SCHEMA, batch_size=6)
        before = c.cursor()
        peeked = c.peek_batches(n_peek)
        o.items.append([{k: v.tolist() for k, v in b.items()} for b in peeked])
        assert c.cursor() == before
        batch = o.batch(c.next_batch())[0]
        assert batch["x"].tolist() == peeked[0]["x"].tolist()
        o.state(c)
    _twin(tmp_path, lambda r: _write(r, n_records, rows=3), script)


def test_gc_consumed_segments(tmp_path):
    def script(m, root, o):
        c = m.ReplayConsumer(root, schema=SCHEMA, batch_size=6)
        o.drain(c)
        deleted = o.call(c.gc_consumed_segments, keep=1)
        assert deleted == list(range(c.cursor()["segment"] - 1))
        o.call(c.gc_consumed_segments, keep=1)
        o.items.append(sorted(p.name for p in root.iterdir()))
        c2 = m.ReplayConsumer(root, schema=SCHEMA, batch_size=6,
                              cursor=c.cursor())
        assert o.batch(c2.next_batch()) is None
    _twin(tmp_path, lambda r: _write(r, 12, rows=3, segment_bytes=256), script)


def test_gc_refusals(tmp_path):
    def script(m, root, o):
        c = m.ReplayConsumer(root, schema=SCHEMA, batch_size=6)
        o.batch(c.next_batch())
        o.call(c.gc_segments, c.cursor()["segment"])
        o.call(c.gc_consumed_segments)
        o.drain(c)
        os.unlink(sorted(root.glob("*.seal.json"))[0])
        o.call(c.gc_consumed_segments)
        o.items.append(sorted(p.name for p in root.iterdir()))
    _twin(tmp_path, lambda r: _write(r, 12, rows=3, segment_bytes=256), script)


# -------------------------------------------------------------- fleet merge


def test_merged_round_robin_exactly_once(tmp_path):
    def script(m, root, o):
        c = m.make_replay_consumer(root, schema=SCHEMA, batch_size=6)
        assert isinstance(c, m.MergedReplayConsumer)
        xs = o.drain(c)
        o.state(c)
        return xs
    xs = _twin(tmp_path, lambda r: _write_fleet(r, 4, rows=3), script)
    assert xs == [0, 1, 2, 1000, 1001, 1002, 3, 4, 5, 1003, 1004, 1005,
                  6, 7, 8, 1006, 1007, 1008, 9, 10, 11, 1009, 1010, 1011]


def test_merged_mid_record_cursor_resume(tmp_path):
    def script(m, root, o):
        c1 = m.MergedReplayConsumer(root, schema=SCHEMA, batch_size=4)
        o.batch(c1.next_batch())
        saved = json.loads(json.dumps(c1.cursor()))
        c2 = m.MergedReplayConsumer(root, schema=SCHEMA, batch_size=4,
                                    cursor=saved)
        o.drain(c2)
        o.state(c2)
    _twin(tmp_path, lambda r: _write_fleet(r, 3, rows=5), script)


def test_merged_uncommitted_and_peek(tmp_path):
    def build(root):
        _write_fleet(root, 4, rows=3)
        log = trep.RequestLog(trep.replica_log_dir(root, 2))
        log.append(_record(2, x0=2000))
        log.close()

    def script(m, root, o):
        c = m.MergedReplayConsumer(root, schema=SCHEMA, batch_size=6)
        before = json.dumps(c.cursor(), sort_keys=True)
        peeked = c.peek_batches(2)
        o.items.append([b["x"].tolist() for b in peeked])
        assert json.dumps(c.cursor(), sort_keys=True) == before
        o.drain(c)
        o.state(c)
        big = m.MergedReplayConsumer(root, schema=SCHEMA, batch_size=64)
        assert o.batch(big.next_batch()) is None
        o.state(big)
    _twin(tmp_path, build, script)


def test_merged_cursor_refusals(tmp_path):
    def script(m, root, o):
        plain = {"segment": 0, "offset": 0, "row": 0, "records": 2}
        o.call(m.MergedReplayConsumer, root, schema=SCHEMA, batch_size=6,
               cursor=plain)
        c = m.MergedReplayConsumer(root, schema=SCHEMA, batch_size=6)
        o.batch(c.next_batch())
        o.call(m.ReplayConsumer, m.replica_log_dir(root, 0), schema=SCHEMA,
               batch_size=6, cursor=c.cursor())
        cur = c.cursor()
        cur["replicas"]["7"] = dict(cur["replicas"]["0"])
        o.call(m.MergedReplayConsumer, root, schema=SCHEMA, batch_size=6,
               cursor=cur)
        o.call(m.MergedReplayConsumer, m.replica_log_dir(root, 0),
               schema=SCHEMA, batch_size=6)
        assert isinstance(m.make_replay_consumer(
            m.replica_log_dir(root, 0), schema=SCHEMA, batch_size=6),
            m.ReplayConsumer)
    _twin(tmp_path, lambda r: _write_fleet(r, 2, rows=3), script)


def test_merged_gc_and_backpressure(tmp_path):
    def script(m, root, o):
        c = m.MergedReplayConsumer(root, schema=SCHEMA, batch_size=6,
                                   max_lag_records=20, lag_policy="skip")
        o.call(c.check_backpressure)
        o.state(c)
        o.drain(c)
        o.call(c.gc_consumed_segments)
        o.call(c.gc_consumed_segments)
        o.state(c)
    _twin(tmp_path, lambda r: _write_fleet(r, 12, rows=3, segment_bytes=256),
          script)
