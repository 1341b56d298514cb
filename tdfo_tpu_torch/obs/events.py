"""Build/capture + device-memory event recorder (``events.jsonl``) — port of
``tdfo_tpu/obs/events.py``.

The reference parses jax's dispatch logger for every XLA compilation.  The
port compiles no XLA programs; what it does build or capture at run time
announces itself here through :func:`compiled`:

* each kernel library that ``ops/kernels/build.py`` compiles with ``nvcc``
  (``kernel_build:<kernel>``; a library reused from the build cache is not
  a build);
* each CUDA-graph capture of ``train/step.py::CudaGraphStep``
  (``cuda_graph:train_step``);
* each new serving program, a batch signature a scorer had not run
  before (``serving_program:<shapes>``: ``serve/scoring.py::CountedScore``,
  the programs ``score_cache_size`` counts).

Every one lands in ``events.jsonl`` as the reference's ``compile`` record
(``name``, ``duration_s``, per-name ``count``, ``after_warmup``); those
after :func:`mark_warmup` are flagged ``after_warmup`` with the
reference's loud warning (a build in steady state means a shape leak, or a
scorer swap that rebuilt its programs).  ``memory_snapshot`` samples
``torch.cuda.memory_stats`` (live and peak allocated bytes) per card and
keeps a run-peak watermark for the final ``run_summary`` record; it is
None on the CPU, as the reference's is on devices without memory stats.

Process-global, configured once per run like ``utils/faults.configure``;
with no recorder configured every call returns at once.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)

__all__ = ["active", "compile_count", "compiled", "configure", "mark_warmup",
           "memory_snapshot", "peak_memory", "record"]

_LOCK = threading.Lock()
_ACTIVE: Optional["_Recorder"] = None


class _Recorder:
    def __init__(self, path, rotate_bytes: int = 0):
        self.path = os.fspath(path)
        self.rotate_bytes = int(rotate_bytes)
        self.after_warmup = False
        self.counts: dict = {}  # (kind, name) -> occurrences
        self.peak_bytes: dict = {}  # device label -> most bytes seen
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        open(self.path, "w").close()  # one recorder per run

    def record(self, kind: str, **fields) -> None:
        from tdfo_tpu_torch.utils.logrotate import maybe_rotate_path

        rec = {"time": time.time(), "kind": kind, **fields}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.rotate_bytes:
            maybe_rotate_path(self.path, self.rotate_bytes)


def configure(path=None, *, rotate_bytes: int = 0) -> None:
    """Start recording to ``path`` (``events.jsonl``); ``None`` stops.
    ``rotate_bytes > 0``: ``[telemetry] log_rotate_bytes``."""
    global _ACTIVE
    with _LOCK:
        _ACTIVE = (None if path is None
                   else _Recorder(path, rotate_bytes=rotate_bytes))


def active() -> bool:
    return _ACTIVE is not None


def compiled(name: str, duration_s: float) -> None:
    """Record one build or capture (``kind = "compile"``); after warm-up it
    is flagged and warned about."""
    rec = _ACTIVE
    if rec is None:
        return
    with _LOCK:
        n = rec.counts[("compile", name)] = rec.counts.get(("compile", name), 0) + 1
        late = rec.after_warmup
        rec.record("compile", name=name, duration_s=float(duration_s), count=n,
                   after_warmup=late)
    if late:
        logger.warning(
            "UNEXPECTED RETRACE: %s compiled after warmup (occurrence %d, "
            "%.3fs) — a shape/dtype leak is invalidating the program cache",
            name, n, duration_s)


def mark_warmup() -> None:
    """Declare warm-up over: later builds are unexpected."""
    rec = _ACTIVE
    if rec is not None:
        rec.after_warmup = True
        with _LOCK:
            rec.record("warmup_done")


def record(kind: str, **fields) -> None:
    """Append an arbitrary event."""
    rec = _ACTIVE
    if rec is not None:
        with _LOCK:
            rec.record(kind, **fields)


def compile_count(name_substr: Optional[str] = None) -> int:
    """Builds recorded (optionally those whose name holds ``name_substr``)."""
    rec = _ACTIVE
    if rec is None:
        return 0
    with _LOCK:
        return sum(n for (kind, name), n in rec.counts.items()
                   if kind == "compile"
                   and (name_substr is None or name_substr in name))


def memory_snapshot(devices=None) -> Optional[list]:
    """Per-card live and peak allocated bytes; None off the card.  Updates
    the run-peak watermark and appends a ``memory`` event when recording."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    stats = []
    for i in (devices if devices is not None else range(torch.cuda.device_count())):
        d = torch.device("cuda", i) if isinstance(i, int) else torch.device(i)
        s = torch.cuda.memory_stats(d)
        if not s:
            continue
        stats.append({
            "device": str(d),
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
        })
    if not stats:
        return None
    rec = _ACTIVE
    if rec is not None:
        with _LOCK:
            for s in stats:
                rec.peak_bytes[s["device"]] = max(
                    rec.peak_bytes.get(s["device"], 0),
                    s["peak_bytes_in_use"] or s["bytes_in_use"])
            rec.record("memory", devices=stats)
    return stats


def peak_memory() -> dict:
    """Run-peak watermark per card (the ``run_summary`` record's)."""
    rec = _ACTIVE
    if rec is None:
        return {}
    with _LOCK:
        return dict(rec.peak_bytes)
