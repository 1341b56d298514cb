"""The request log's writer — port of the writer half of
``tdfo_tpu/data/replay.py`` (``RequestLog``, ``replica_log_dir``, the
segment and seal naming, ``ReplayError``).

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
act here.  The readers (``ReplayConsumer``, ``MergedReplayConsumer``) are
not ported yet (``ROADMAP.md`` item 16).
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any

from tdfo_tpu_torch.utils import faults as _faults

__all__ = [
    "REPLAY_SCHEMA_VERSION",
    "ReplayError",
    "RequestLog",
    "replica_log_dir",
]

REPLAY_SCHEMA_VERSION = 1


class ReplayError(RuntimeError):
    """Unrecoverable log damage (the reader's error; the writer half shares
    the name so both packages' logs are refused alike)."""


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
