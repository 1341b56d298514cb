"""Crash-safe request-log replay — port of ``tdfo_tpu/data/replay.py``,
both halves: the writer (``RequestLog``) and the readers
(``ReplayConsumer``, ``MergedReplayConsumer``, ``make_replay_consumer``).

Every served request is appended as one JSON line stamped with ``seq``
and ``schema_version``.  Appends rotate into a new segment at
``segment_bytes``; a finished segment is sealed by an atomically
published sidecar (``requests-NNNNNN.seal.json``: bytes, records, first
and last seq, sha256) before its successor opens.  Reopening after a
crash truncates a torn tail line and resumes ``seq`` from the last durable
record, so one writer never emits a seq twice.  A fleet writes one log per
replica (``<root>/replica-<k>``).  Segments and seals are byte-identical to
the reference's for the same records.  The ``[faults]`` triggers
``truncate_log_at_byte``, ``dup_record_nth`` and ``corrupt_record_nth``
act here.

``ReplayConsumer`` tails the segment chain from a byte-offset cursor (the
online loop persists it beside each checkpoint) and forms fixed-size
training batches exactly once: the cursor commits only when a whole batch
assembles, ``seq`` dedup drops writer-retry duplicates, sealed segments are
digest-verified once, a torn tail in the active segment stops the tail,
and complete-but-garbage lines are quarantined up to ``max_bad_records``.
The counters (``records``, ``bad``, ``dup``, ``skipped``) travel inside the
cursor.  ``MergedReplayConsumer`` folds a fleet's per-replica logs into one
stream keyed by ``(replica_id, seq)``, round-robin over whole records.
Batches, cursors, counters and quarantine decisions are host data and
equal the reference's exactly on the same log bytes.  ``kill_during_replay``
acts in ``next_batch``.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any, Iterator

import numpy as np

from tdfo_tpu_torch.obs import trace as _trace
from tdfo_tpu_torch.utils import faults as _faults

__all__ = [
    "REPLAY_SCHEMA_VERSION",
    "MergedReplayConsumer",
    "ReplayError",
    "ReplayLagError",
    "RequestLog",
    "ReplayConsumer",
    "make_replay_consumer",
    "replica_log_dir",
]

REPLAY_SCHEMA_VERSION = 1


class ReplayError(RuntimeError):
    """Unrecoverable log damage: digest mismatch, unsealed non-final
    segment, or the bad-record quarantine budget exhausted."""


class ReplayLagError(ReplayError):
    """The consumer fell further behind than ``max_lag_records`` under the
    fail-hard backpressure policy."""


def _seg_name(i: int) -> str:
    return f"requests-{i:06d}.jsonl"


def _seal_name(i: int) -> str:
    return f"requests-{i:06d}.seal.json"


def _list_segments(root: Path) -> list[int]:
    out = []
    for p in root.glob("requests-*.jsonl"):
        stem = p.name[len("requests-"):-len(".jsonl")]
        if stem.isdigit():
            out.append(int(stem))
    return sorted(out)


def replica_log_dir(root: str | Path, replica_id: int) -> Path:
    """Per-replica request-log directory under a fleet log root — the
    naming contract the fleet writer and the merged reader share."""
    return Path(root) / f"replica-{replica_id}"


def _list_replicas(root: Path) -> list[int]:
    out = []
    for p in root.glob("replica-*"):
        stem = p.name[len("replica-"):]
        if p.is_dir() and stem.isdigit():
            out.append(int(stem))
    return sorted(out)


# --------------------------------------------------------------------- writer


class RequestLog:
    """Append-only, segment-rotated JSONL writer with sealed digests.

    ``segment_bytes = 0`` disables rotation (single growing segment —
    fine for tests, wrong for a long-running frontend).  Rotation order is
    the crash-safety invariant: the seal sidecar is atomically published
    (temp + fsync + rename, via the swap store's sanctioned helper) BEFORE
    the next segment is created, so a reader that finds an unsealed segment
    with a successor knows the chain is damaged rather than racing.
    """

    def __init__(self, root: str | Path, *, segment_bytes: int = 0):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.segment_bytes = int(segment_bytes)
        segs = _list_segments(self.root)
        self._seg = segs[-1] if segs else 0
        self._seq = 0
        if segs and (self.root / _seal_name(self._seg)).exists():
            # crashed between sealing and opening the successor: resume seq
            # from the seal and start the next segment fresh
            seal = json.loads((self.root / _seal_name(self._seg)).read_text())
            self._seq = int(seal.get("last_seq") or 0)
            self._seg += 1
        elif segs:
            self._seq = self._recover_active(self.root / _seg_name(self._seg))
            if self._seg:
                # a fresh (or torn-empty) active segment carries no seqs —
                # continuity lives in the predecessor's seal
                prev = self.root / _seal_name(self._seg - 1)
                if prev.exists():
                    seal = json.loads(prev.read_text())
                    self._seq = max(self._seq,
                                    int(seal.get("last_seq") or 0))
        self._path = self.root / _seg_name(self._seg)
        self._first_seq = None  # first seq in the ACTIVE segment
        self._records = 0  # lines in the active segment
        self._f = open(self._path, "ab")
        if self._path.stat().st_size:
            first, n = self._scan_segment(self._path)[:2]
            self._first_seq, self._records = first, n

    def _recover_active(self, path: Path) -> int:
        """Truncate a torn tail line (no trailing newline) and return the
        highest seq among the surviving complete records."""
        data = path.read_bytes()
        cut = data.rfind(b"\n") + 1  # 0 when no complete line survives
        if cut != len(data):
            with open(path, "r+b") as f:
                f.truncate(cut)
        last = 0
        for line in data[:cut].split(b"\n"):
            if not line:
                continue
            try:
                rec = json.loads(line)
                last = max(last, int(rec.get("seq") or 0))
            except (ValueError, TypeError):
                continue  # corrupt line: reader quarantines it; seq unknown
        return last

    def _scan_segment(self, path: Path) -> tuple[int | None, int, int]:
        """(first_seq, line_count, last_seq) of a segment's complete lines."""
        first, last, n = None, 0, 0
        for line in path.read_bytes().split(b"\n"):
            if not line:
                continue
            n += 1
            try:
                seq = int(json.loads(line).get("seq") or 0)
            except (ValueError, TypeError):
                continue
            first = seq if first is None else first
            last = max(last, seq)
        return first, n, last

    # ------------------------------------------------------------------ api

    def append(self, record: dict[str, Any]) -> int:
        """Append one record (stamped with ``seq`` + ``schema_version``),
        flush it to the OS, and rotate if the segment crossed the byte
        threshold.  Returns the assigned seq."""
        self._seq += 1
        seq = self._seq
        rec = dict(record)
        rec["seq"] = seq
        rec["schema_version"] = REPLAY_SCHEMA_VERSION
        line = (json.dumps(rec) + "\n").encode()
        inj = _faults.active()
        if inj is not None and inj.corrupt_record_due():
            # complete-but-garbage line: '{' -> '#' can never parse as JSON,
            # driving the reader's quarantine on a REAL sealed bad line
            line = b"#" + line[1:]
        self._f.write(line)
        if inj is not None and inj.dup_record_due():
            self._f.write(line)  # same seq twice: the at-least-once artifact
            self._records += 1
        self._f.flush()
        if self._first_seq is None:
            self._first_seq = seq
        self._records += 1
        if inj is not None:
            size = self._f.tell()
            if inj.truncate_log_due(size):
                # torn tail mid-record, as a crashed writer leaves it; a
                # reopened RequestLog truncates it, the reader stops before it
                self._f.truncate(inj.spec.truncate_log_at_byte)
                self._f.seek(inj.spec.truncate_log_at_byte)
        if self.segment_bytes and self._f.tell() >= self.segment_bytes:
            self._rotate()
        return seq

    def _rotate(self) -> None:
        """Seal the active segment (fsync data, publish the digest sidecar)
        THEN open the successor — a reader can always tell 'rotation in
        flight' from 'chain damaged'."""
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self.seal_segment(self._seg)
        self._seg += 1
        self._path = self.root / _seg_name(self._seg)
        self._f = open(self._path, "ab")
        self._first_seq = None
        self._records = 0

    def seal_segment(self, seg: int) -> None:
        """Publish the digest sidecar for a finished segment."""
        from tdfo_tpu_torch.serve.swap import atomic_write_json

        path = self.root / _seg_name(seg)
        data = path.read_bytes()
        first, n, last = self._scan_segment(path)
        atomic_write_json(self.root / _seal_name(seg), {
            "segment": seg,
            "schema_version": REPLAY_SCHEMA_VERSION,
            "bytes": len(data),
            "records": n,
            "first_seq": first,
            "last_seq": last,
            "sha256": hashlib.sha256(data).hexdigest(),
        })

    def seal_active(self) -> None:
        """Force-seal the active segment (end-of-stream marker for tests and
        drained frontends) and open a fresh successor on the next append."""
        if self._f.closed:
            return
        if self._path.stat().st_size == 0:
            return  # nothing to seal; an empty sealed segment is noise
        self._rotate()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    @property
    def active_segment(self) -> int:
        return self._seg

    @property
    def last_seq(self) -> int:
        return self._seq


# --------------------------------------------------------------------- reader


def _fresh_cursor() -> dict[str, int]:
    return {"segment": 0, "offset": 0, "row": 0,
            "records": 0, "bad": 0, "dup": 0, "skipped": 0, "last_seq": 0}

_CURSOR_KEYS = frozenset(_fresh_cursor())


class ReplayConsumer:
    """Exactly-once batch former over a ``RequestLog`` directory.

    ``schema`` is the trainer's ``_eval_schema`` dict (``{column: (dtype,
    shape)}``); only records whose feature payload validates against it
    train.  ``cursor`` resumes from a previously committed position (the
    checkpoint sidecar); omit it to start at segment 0, byte 0.
    """

    def __init__(self, root: str | Path, *, schema: dict[str, tuple],
                 batch_size: int, max_bad_records: int = 0,
                 max_lag_records: int = 0, lag_policy: str = "fail",
                 cursor: dict[str, int] | None = None):
        if lag_policy not in ("fail", "skip"):
            raise ValueError(f"lag_policy must be 'fail' or 'skip', "
                             f"got {lag_policy!r}")
        for col, (_, shape) in schema.items():
            shape = tuple(shape)
            # scalar-per-row (CTR) or fixed-width vector-per-row (seq eval
            # windows / candidate panels) — anything ragged or higher-rank
            # cannot form deterministic fixed-size batches
            if len(shape) > 1 or (shape and int(shape[0]) <= 0):
                raise ValueError(
                    f"replay schema column {col!r} must be scalar or a "
                    f"fixed-width 1-D vector per row, got shape {shape} — "
                    "ragged payloads cannot batch deterministically")
        self.root = Path(root)
        self.schema = dict(schema)
        self.batch_size = int(batch_size)
        self.max_bad_records = int(max_bad_records)
        self.max_lag_records = int(max_lag_records)
        self.lag_policy = lag_policy
        cur = _fresh_cursor()
        if cursor is not None:
            unknown = set(cursor) - _CURSOR_KEYS
            if unknown:
                raise ValueError(f"unknown replay cursor keys: {sorted(unknown)}")
            cur.update({k: int(v) for k, v in cursor.items()})
        self._cursor = cur
        self._verified: set[int] = set()
        self._peeking = False  # suppress trace spans for uncommitted reads

    # ------------------------------------------------------------- segments

    def _seal(self, seg: int) -> dict | None:
        p = self.root / _seal_name(seg)
        if not p.exists():
            return None
        return json.loads(p.read_text())

    def _verify(self, seg: int, seal: dict) -> None:
        if seg in self._verified:
            return
        data = (self.root / _seg_name(seg)).read_bytes()
        if len(data) != seal["bytes"]:
            raise ReplayError(
                f"sealed segment {_seg_name(seg)} is {len(data)} bytes, seal "
                f"says {seal['bytes']} — truncated after sealing")
        digest = hashlib.sha256(data).hexdigest()
        if digest != seal["sha256"]:
            raise ReplayError(
                f"sealed segment {_seg_name(seg)} digest mismatch "
                f"({digest[:12]} != {seal['sha256'][:12]}) — refusing to "
                f"replay silently corrupted traffic")
        self._verified.add(seg)

    def _segment_bytes(self, seg: int) -> bytes | None:
        """Readable bytes of a segment: the verified whole file when sealed,
        everything up to the last complete line when active, ``None`` when
        the segment does not exist yet."""
        path = self.root / _seg_name(seg)
        if not path.exists():
            return None
        seal = self._seal(seg)
        if seal is not None:
            self._verify(seg, seal)
            data = path.read_bytes()
            if data and not data.endswith(b"\n"):
                raise ReplayError(
                    f"sealed segment {_seg_name(seg)} ends mid-record — the "
                    f"writer seals only complete lines; refusing torn data")
            return data
        if (self.root / _seg_name(seg + 1)).exists():
            raise ReplayError(
                f"segment {_seg_name(seg)} has a successor but no seal — "
                f"the rotation order guarantees seals land first; this "
                f"chain is damaged")
        data = path.read_bytes()
        cut = data.rfind(b"\n") + 1  # torn tail: wait, don't error
        return data[:cut]

    def _lines(self, cur: dict[str, int]) -> Iterator[tuple[bytes, int, int]]:
        """Yield ``(line, segment, next_offset)`` for every complete line at
        or after the cursor, crossing sealed segment boundaries."""
        seg, offset = cur["segment"], cur["offset"]
        while True:
            data = self._segment_bytes(seg)
            if data is None:
                return
            while offset < len(data):
                end = data.index(b"\n", offset) + 1
                yield data[offset:end - 1], seg, end
                offset = end
            if self._seal(seg) is None:
                return  # active segment exhausted: no more durable data yet
            seg, offset = seg + 1, 0

    # -------------------------------------------------------------- records

    def _classify(self, line: bytes, cur: dict[str, int]):
        """Parse + validate one complete line against the cursor's dedup
        state.  Returns ``("train", record, columns)`` /
        ``("skip"|"dup"|"bad", reason, None)`` and updates the dedup seq."""
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict):
                raise ValueError("record is not an object")
        except (ValueError, TypeError) as e:
            return "bad", f"unparseable line: {e}", None
        seq = rec.get("seq")
        if not isinstance(seq, int) or seq <= 0:
            return "bad", "missing/invalid seq", None
        if seq <= cur["last_seq"]:
            return "dup", f"seq {seq} already consumed", None
        cur["last_seq"] = seq
        if rec.get("schema_version") != REPLAY_SCHEMA_VERSION:
            return "bad", f"schema_version {rec.get('schema_version')!r}", None
        if (rec.get("event") != "serve_request" or rec.get("outcome") != "ok"
                or "features" not in rec):
            return "skip", "not a trainable serve_request", None
        feats = rec["features"]
        if not isinstance(feats, dict):
            return "bad", "features is not an object", None
        rows = rec.get("rows")
        if not isinstance(rows, int) or rows <= 0:
            return "bad", "missing/invalid rows", None
        cols = {}
        for col, (dtype, shape) in self.schema.items():
            vals = feats.get(col)
            if not isinstance(vals, list) or len(vals) != rows:
                return "bad", f"feature {col!r} missing or wrong length", None
            try:
                arr = np.asarray(vals, dtype=dtype)
            except (ValueError, TypeError, OverflowError):
                return "bad", f"feature {col!r} not castable to {dtype}", None
            # enforce the per-row shape exactly (seq panels: [rows, width]);
            # a drifted width would desync multihost lockstep downstream
            if arr.shape != (rows, *tuple(shape)):
                return ("bad", f"feature {col!r} has shape {arr.shape}, "
                        f"schema says {(rows, *tuple(shape))}", None)
            cols[col] = arr
        return "train", rec, cols

    # ------------------------------------------------------------------ api

    def cursor(self) -> dict[str, int]:
        """The committed cursor (a copy — safe to persist as-is)."""
        return dict(self._cursor)

    def lag(self) -> int:
        """Complete records durable in the log but not yet consumed — the
        records-behind backpressure metric (``replay/lag``)."""
        n = 0
        seg, offset = self._cursor["segment"], self._cursor["offset"]
        while True:
            data = self._segment_bytes(seg)
            if data is None:
                return n
            n += data.count(b"\n", offset)
            if self._seal(seg) is None:
                return n
            seg, offset = seg + 1, 0

    def counters(self) -> dict[str, float]:
        """Replay counters for the telemetry JSONL (the reference's names)."""
        c = self._cursor
        return {
            "replay/records": float(c["records"]),
            "replay/bad": float(c["bad"]),
            "replay/dup": float(c["dup"]),
            "replay/skipped": float(c["skipped"]),
            "replay/lag": float(self.lag()),
        }

    def check_backpressure(self) -> int:
        """Enforce the bounded-lag policy.  Returns the measured lag.
        ``fail``: raise ``ReplayLagError`` beyond ``max_lag_records``.
        ``skip``: drop whole records (counted, dedup-consistent) until at
        most ``max_lag_records`` remain — skip-to-fresh for a consumer that
        prefers recency over completeness."""
        lag = self.lag()
        if not self.max_lag_records or lag <= self.max_lag_records:
            return lag
        if self.lag_policy == "fail":
            raise ReplayLagError(
                f"replay is {lag} records behind (max_lag_records="
                f"{self.max_lag_records}); the frontend outpaces training — "
                f"fail-hard policy refuses to silently train on stale data")
        cur = dict(self._cursor)
        to_drop = lag - self.max_lag_records
        for line, seg, next_offset in self._lines(cur):
            if to_drop <= 0:
                break
            try:
                rec = json.loads(line)
                seq = rec.get("seq")
                if isinstance(seq, int) and seq > cur["last_seq"]:
                    cur["last_seq"] = seq
            except (ValueError, TypeError):
                pass  # unparseable skipped line: nothing to dedup against
            cur["segment"], cur["offset"], cur["row"] = seg, next_offset, 0
            cur["skipped"] += 1
            to_drop -= 1
        self._cursor = cur
        return self.lag()

    def _take(self, cur: dict[str, int], taken: dict[str, list],
              consumed: list[tuple[int, int, int]], need: int, *,
              max_records: int | None = None) -> int:
        """Advance the WORKING cursor ``cur`` over the log, appending up to
        ``need`` rows of trainable columns into ``taken`` and their
        ``(seq, row_start, row_end)`` spans into ``consumed``.  Stops after
        ``max_records`` whole train records (the merged consumer's record-
        level round-robin grain), when ``need`` is filled, or when durable
        data runs out.  Returns the rows taken; commits nothing."""
        got, records = 0, 0
        for line, seg, next_offset in self._lines(cur):
            prev_seq = cur["last_seq"]  # restored on a mid-record boundary
            kind, info, cols = self._classify(line, cur)
            if kind == "bad":
                cur["bad"] += 1
                if cur["bad"] > self.max_bad_records:
                    raise ReplayError(
                        f"bad request-log record #{cur['bad']} exceeds "
                        f"max_bad_records={self.max_bad_records} "
                        f"(segment {seg}): {info}")
                cur["segment"], cur["offset"], cur["row"] = seg, next_offset, 0
                continue
            if kind in ("dup", "skip"):
                cur["dup" if kind == "dup" else "skipped"] += 1
                cur["segment"], cur["offset"], cur["row"] = seg, next_offset, 0
                continue
            rec, start = info, cur["row"]
            rows = rec["rows"]
            if start >= rows:  # cursor damage: row offset beyond the record
                raise ReplayError(
                    f"cursor row {start} >= record rows {rows} at seq "
                    f"{rec['seq']} — cursor does not match this log")
            stop = min(rows, start + need - got)
            for col, arr in cols.items():
                taken[col].append(arr[start:stop])
            consumed.append((rec["seq"], start, stop))
            got += stop - start
            if stop == rows:
                cur["records"] += 1
                cur["segment"], cur["offset"], cur["row"] = seg, next_offset, 0
                records += 1
            else:
                # mid-record batch boundary: stay ON this line, resume at row
                # `stop`; un-bump the dedup seq so the re-read is not a dup
                cur["row"] = stop
                cur["last_seq"] = prev_seq
            if got >= need:
                break
            if max_records is not None and records >= max_records:
                break
        return got

    def next_batch(self):
        """Assemble one deterministic batch of exactly ``batch_size`` rows.

        Returns ``(batch, consumed)`` — ``batch`` maps schema columns to
        ``[batch_size]`` arrays; ``consumed`` lists ``(seq, row_start,
        row_end)`` spans for record-id accounting — or ``None`` when fewer
        than ``batch_size`` rows are durably available (partial progress is
        discarded; the cursor only ever commits whole batches)."""
        cur = dict(self._cursor)
        taken: dict[str, list] = {col: [] for col in self.schema}
        consumed: list[tuple[int, int, int]] = []
        got = self._take(cur, taken, consumed, self.batch_size)
        if got < self.batch_size:
            return None  # not enough durable rows: all-or-nothing, no commit
        batch = {col: np.concatenate(parts) for col, parts in taken.items()}
        self._cursor = cur
        # span AFTER the in-memory commit: what the trace claims consumed
        # is exactly what the cursor advanced over ((seq, lo, hi) spans —
        # obs/aggregate.py normalises them to (replica=0, seq) join keys).
        # Peeks (shadow eval) never emit — they commit nothing.
        if not self._peeking:
            _trace.emit("replay", "replay_batch", rows=self.batch_size,
                        consumed=[list(c) for c in consumed],
                        records=cur["records"])
        inj = _faults.active()
        if inj is not None:
            inj.maybe_kill_replay(cur["records"])
        return batch, consumed

    def peek_batches(self, n: int) -> list[dict[str, np.ndarray]]:
        """Read up to ``n`` batches PAST the committed position without
        moving the cursor — the gated supervisor's shadow-eval slice:
        traffic the cycle's candidate has NOT trained on (it trains in a
        later cycle — progressive validation), so gate scores are always
        held-out.  Returns fewer than ``n`` batches when the log drains."""
        saved = dict(self._cursor)
        out = []
        self._peeking = True
        try:
            for _ in range(int(n)):
                got = self.next_batch()
                if got is None:
                    break
                out.append(got[0])
        finally:
            self._peeking = False
            self._cursor = saved
        return out

    # -------------------------------------------------------------- retention

    def gc_segments(self, upto: int) -> list[int]:
        """Delete sealed segments ``0..upto`` (data + seal sidecar).
        REFUSES — ``ValueError``, nothing deleted — when the committed
        cursor still points into any candidate segment, or when a
        candidate below the cursor is unsealed (chain damage a GC must not
        paper over).  Returns the deleted segment indices."""
        upto = int(upto)
        if upto < 0:
            return []
        if upto >= self._cursor["segment"]:
            raise ValueError(
                f"refusing to GC segment {upto}: the committed replay "
                f"cursor still points into segment "
                f"{self._cursor['segment']} — only segments the cursor has "
                "fully passed may be deleted")
        doomed = [i for i in _list_segments(self.root) if i <= upto]
        for i in doomed:
            if self._seal(i) is None:
                raise ValueError(
                    f"refusing to GC segment {i}: no seal sidecar below the "
                    "committed cursor — the rotation order guarantees seals "
                    "land first, so this chain is damaged, not consumable")
        removed = []
        for i in doomed:
            (self.root / _seg_name(i)).unlink()
            (self.root / _seal_name(i)).unlink()
            self._verified.discard(i)
            removed.append(i)
        return removed

    def gc_consumed_segments(self, keep: int = 0) -> list[int]:
        """Retention sweep ([online] keep_consumed_segments): delete fully-
        consumed sealed segments, keeping the newest ``keep`` of them
        behind the committed cursor.  Returns the deleted indices."""
        upto = self._cursor["segment"] - 1 - max(0, int(keep))
        if upto < 0:
            return []
        return self.gc_segments(upto)


class MergedReplayConsumer:
    """Exactly-once batch former over a FLEET of per-replica request logs.

    A multi-replica serving fleet (``serve/fleet.py``) writes one
    ``RequestLog`` per replica under ``<root>/replica-<k>``; this consumer
    folds them into a single deterministic stream.  Identity is
    ``(replica_id, seq)`` — each sub-log keeps its own dedup ``last_seq``,
    so a seq collision ACROSS replicas is two distinct records, while a
    crash-redo WITHIN one replica's log still dedups.  Interleave order is
    record-level round-robin over replica ids ascending, starting from the
    persisted ``rr`` index; a replica with no durable record simply yields
    its turn.  The merged cursor ``{"rr": int, "replicas": {str(id):
    sub_cursor}}`` commits all-or-nothing alongside the cycle checkpoint,
    same single-durability-point discipline as the flat consumer.
    """

    def __init__(self, root: str | Path, *, schema: dict[str, tuple],
                 batch_size: int, max_bad_records: int = 0,
                 max_lag_records: int = 0, lag_policy: str = "fail",
                 cursor: dict | None = None):
        self.root = Path(root)
        self.batch_size = int(batch_size)
        ids = _list_replicas(self.root)
        if not ids:
            raise ValueError(
                f"no replica-<k> request-log directories under {self.root} — "
                f"a merged replay consumer needs a fleet log layout")
        subs: dict | None = None
        self._rr = 0
        if cursor is not None:
            unknown = set(cursor) - {"rr", "replicas"}
            if unknown or "replicas" not in cursor:
                raise ValueError(
                    f"cursor is not a merged replay cursor (keys "
                    f"{sorted(cursor)}) — a fleet log cannot resume from a "
                    f"single-log cursor")
            self._rr = int(cursor.get("rr", 0))
            subs = cursor["replicas"]
            ghost = set(subs) - {str(i) for i in ids}
            if ghost:
                raise ValueError(
                    f"merged replay cursor names replicas {sorted(ghost)} "
                    f"with no log directory under {self.root} — cursor does "
                    f"not match this fleet")
        self._ids = ids
        self._subs = {
            i: ReplayConsumer(
                replica_log_dir(self.root, i), schema=schema,
                batch_size=batch_size, max_bad_records=max_bad_records,
                max_lag_records=max_lag_records, lag_policy=lag_policy,
                cursor=None if subs is None else subs.get(str(i)))
            for i in ids
        }
        self.schema = dict(schema)
        self._peeking = False  # suppress trace spans for uncommitted reads

    def next_batch(self):
        """One deterministic ``batch_size``-row batch round-robined across
        replica logs, or ``None`` when the fleet has too few durable rows.
        ``consumed`` spans are 4-tuples ``(replica_id, seq, row_start,
        row_end)``.  All sub-cursors commit together or not at all."""
        curs = {i: dict(s._cursor) for i, s in self._subs.items()}
        taken: dict[str, list] = {col: [] for col in self.schema}
        consumed: list[tuple[int, int, int, int]] = []
        need = self.batch_size
        got_total = 0
        rr, dry = self._rr, 0
        ids = self._ids
        while got_total < need and dry < len(ids):
            rid = ids[rr % len(ids)]
            sub = self._subs[rid]
            spans: list[tuple[int, int, int]] = []
            got = sub._take(curs[rid], taken, spans, need - got_total,
                            max_records=1)
            consumed.extend((rid, s, a, b) for s, a, b in spans)
            got_total += got
            if got == 0:
                dry += 1
                rr += 1
            else:
                dry = 0
                # a mid-record split keeps the turn so the record finishes
                # contiguously next batch; a whole record passes the turn
                if curs[rid]["row"] == 0:
                    rr += 1
        if got_total < need:
            return None  # all-or-nothing: no sub-cursor moved
        batch = {col: np.concatenate(parts) for col, parts in taken.items()}
        for i, s in self._subs.items():
            s._cursor = curs[i]
        self._rr = rr % len(ids)
        # (replica, seq, lo, hi) spans — the merged half of the causal
        # chain: these ids are the ones served-request spans carry.
        # Peeks (shadow eval) never emit — they commit nothing.
        if not self._peeking:
            _trace.emit("replay", "replay_batch", rows=self.batch_size,
                        consumed=[list(c) for c in consumed])
        inj = _faults.active()
        if inj is not None:
            inj.maybe_kill_replay(
                sum(s._cursor["records"] for s in self._subs.values()))
        return batch, consumed

    def peek_batches(self, n: int) -> list[dict[str, np.ndarray]]:
        """Shadow-eval slice (see ``ReplayConsumer.peek_batches``): up to
        ``n`` batches past the committed position, nothing committed."""
        saved = {i: dict(s._cursor) for i, s in self._subs.items()}
        saved_rr = self._rr
        out = []
        self._peeking = True
        try:
            for _ in range(int(n)):
                got = self.next_batch()
                if got is None:
                    break
                out.append(got[0])
        finally:
            self._peeking = False
            for i, s in self._subs.items():
                s._cursor = saved[i]
            self._rr = saved_rr
        return out

    def cursor(self) -> dict:
        """The committed merged cursor (deep copy — persist as-is)."""
        return {"rr": self._rr,
                "replicas": {str(i): s.cursor()
                             for i, s in self._subs.items()}}

    def lag(self) -> int:
        return sum(s.lag() for s in self._subs.values())

    def counters(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for s in self._subs.values():
            for k, v in s.counters().items():
                out[k] = out.get(k, 0.0) + v
        return out

    def check_backpressure(self) -> int:
        return sum(s.check_backpressure() for s in self._subs.values())

    def gc_consumed_segments(self, keep: int = 0) -> list[tuple[int, int]]:
        """Retention sweep over every replica log.  Returns deleted
        segments as ``(replica_id, segment)`` pairs."""
        out = []
        for i, s in self._subs.items():
            out.extend((i, seg) for seg in s.gc_consumed_segments(keep))
        return out


def make_replay_consumer(root: str | Path, **kw):
    """The one construction point callers should use: a
    ``MergedReplayConsumer`` when ``root`` holds a fleet layout
    (``replica-<k>`` subdirectories), a flat ``ReplayConsumer`` otherwise.
    Keyword arguments pass through unchanged."""
    root = Path(root)
    if _list_replicas(root):
        return MergedReplayConsumer(root, **kw)
    return ReplayConsumer(root, **kw)
