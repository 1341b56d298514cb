"""Span-based causal tracing — port of ``tdfo_tpu/obs/trace.py``.

Every component appends structured spans to a per-component
``trace-<component>.jsonl`` sink under one trace directory, carrying the
ids that chain a served request ``(replica, seq)`` to the version and
digest that served it (``obs/aggregate.py`` joins the sinks offline).
The contract is the reference's:

  * **Off is free.**  Until :func:`configure` attaches a directory,
    ``emit`` returns at once: no file I/O, no id minting.
  * **Every line is complete.**  Each record is ONE ``os.write`` of one
    JSON line on an ``O_APPEND`` descriptor, opened and closed per record
    and size-capped by ``utils/logrotate.maybe_rotate_path``, so several
    replica processes appending to one sink never interleave inside a line
    and a kill between appends never tears one.
  * **Ids are deterministic.**  Span ids come from a locked module counter,
    never ``uuid``/``random``; the join keys are the domain ids.

Clock discipline: ``ts`` is ``time.time()`` (never differenced; the one
clock comparable across processes); durations use the monotonic clock
through :func:`clock` / :func:`elapsed_ms` / :func:`elapsed_s`, the one
place that differences it.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Iterator

from tdfo_tpu_torch.utils.logrotate import maybe_rotate_path

_LOCK = threading.Lock()
_ROOT: Path | None = None
_ROTATE_BYTES = 0
_NEXT_ID = 0


def configure(root_dir: str | Path | None = None, *,
              rotate_bytes: int = 0) -> None:
    """Attach the module-global trace sink directory (``None`` detaches).

    The module-global configure/active shape of ``obs/events.py`` and
    ``utils/faults.py``: emission sites call ``emit`` unconditionally and
    the deconfigured path falls through for free."""
    global _ROOT, _ROTATE_BYTES, _NEXT_ID
    with _LOCK:
        _ROOT = Path(root_dir) if root_dir is not None else None
        _ROTATE_BYTES = int(rotate_bytes)
        _NEXT_ID = 0
        if _ROOT is not None:
            _ROOT.mkdir(parents=True, exist_ok=True)


def active() -> bool:
    return _ROOT is not None


def trace_dir() -> Path | None:
    return _ROOT


def clock() -> float:
    """Monotonic timestamp for host-loop interval timing.

    Pair with ``elapsed_ms``/``elapsed_s`` — the subtraction happens HERE
    (the one sanctioned monotonic-differencing site) so callers never
    lexically difference a clock, and every wall-time measurement is
    audited in one place.  NOT for device timing: a span that must cover
    device work closes after the result is on the host."""
    return time.monotonic()


def elapsed_ms(t0: float) -> float:
    """Milliseconds elapsed since ``t0`` (a ``clock()`` value)."""
    return (time.monotonic() - t0) * 1000.0


def elapsed_s(t0: float) -> float:
    """Seconds elapsed since ``t0`` (a ``clock()`` value)."""
    return time.monotonic() - t0


def emit(component: str, kind: str, **fields) -> None:
    """Append one complete span line to ``trace-<component>.jsonl``.

    No-op (early return, no I/O) unless ``configure`` attached a sink
    directory.  Values must be JSON-serializable — callers pass domain ids
    and plain numbers, never arrays."""
    root = _ROOT
    if root is None:
        return
    global _NEXT_ID
    with _LOCK:
        if _ROOT is None:  # detached while waiting on the lock
            return
        _NEXT_ID += 1
        rec = {"span": _NEXT_ID, "ts": time.time(), "component": component,
               "kind": kind, **fields}
        path = _ROOT / f"trace-{component}.jsonl"
        line = (json.dumps(rec) + "\n").encode()
        fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, line)  # one write: whole lines across processes
        finally:
            os.close(fd)
        if _ROTATE_BYTES:
            maybe_rotate_path(path, _ROTATE_BYTES)


@contextlib.contextmanager
def span(component: str, kind: str, **fields) -> Iterator[dict]:
    """Time a region and emit one span with ``dur_ms`` on exit.

    Yields a dict the body may add fields to (verdict, counts); the span is
    emitted even when the body raises, so killed stages still leave their
    partial timing behind.  When tracing is off the body runs untouched
    (the yielded dict just falls on the floor)."""
    if _ROOT is None:
        yield {}
        return
    extra: dict = {}
    t0 = clock()
    try:
        yield extra
    finally:
        emit(component, kind, dur_ms=round(elapsed_ms(t0), 3),
             **{**fields, **extra})
