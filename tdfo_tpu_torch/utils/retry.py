"""Retryable I/O: exponential backoff + jitter, bounded attempts, JSONL log.

Port of ``tdfo_tpu/utils/retry.py`` (the loader calls :func:`retry_call`).
The port has no fault injector yet (``utils/faults.py``), so the
``fail_io_nth`` hook is absent, and the failure log is not rotated.  The
reference's docstring follows.

The reference stacks assume I/O never fails mid-run (orbax writes, parquet
opens, TFRecord scans all raise straight through and kill the job).  On
preemptible TPU fleets the common failures are transient — GCS 5xx, NFS
staleness, a checkpoint write racing a preemption — and a bounded retry with
backoff is the difference between "training survived" and "8 hours lost".

Every failure (retried or terminal) is appended to an in-memory ring and,
when :func:`set_failure_log` configured a path, to a JSONL file — the same
observability convention as the trainer's ``metrics.jsonl``.

"""

from __future__ import annotations

import collections
import json
import random
import time
from pathlib import Path
from typing import Any, Callable, Iterable

__all__ = ["backoff_delay", "retry_call", "set_failure_log", "recent_failures"]

# last N failure records, observable by tests and post-mortems even when no
# log file is configured
_RECENT: collections.deque = collections.deque(maxlen=256)
_LOG_PATH: Path | None = None


def set_failure_log(path: str | Path | None) -> None:
    """Route failure records to a JSONL file (``None`` disables).  The
    trainer points this at ``<log_dir>/retries.jsonl``."""
    global _LOG_PATH
    _LOG_PATH = Path(path) if path is not None else None


def recent_failures() -> list[dict[str, Any]]:
    """The in-memory ring of recent failure records (newest last)."""
    return list(_RECENT)


def _record(rec: dict[str, Any]) -> None:
    _RECENT.append(rec)
    if _LOG_PATH is not None:
        try:
            _LOG_PATH.parent.mkdir(parents=True, exist_ok=True)
            with open(_LOG_PATH, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass  # the failure log must never turn a retry into a crash


def backoff_delay(
    attempt: int,
    *,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    jitter: float = 0.5,
    rng: random.Random | None = None,
) -> float:
    """Jittered exponential backoff: ``base_delay * 2**attempt`` capped at
    ``max_delay``, then spread by up to ``jitter`` fraction (full-jitter-lite;
    the cap applies BEFORE jitter, so the worst case is
    ``max_delay * (1 + jitter)``).  ``rng`` is injectable so tests pin the
    draw; ``attempt`` is 0-based.  The single backoff law for the repo —
    checkpoint I/O and serving bundle loads both go through here via
    :func:`retry_call`."""
    if attempt < 0:
        raise ValueError(f"attempt must be >= 0, got {attempt}")
    delay = min(base_delay * (2 ** attempt), max_delay)
    return delay * (1.0 + jitter * (rng or random.Random()).random())


def retry_call(
    fn: Callable,
    *args: Any,
    description: str,
    attempts: int = 3,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    jitter: float = 0.5,
    retry_on: tuple[type[BaseException], ...] | Iterable[type[BaseException]] = (OSError,),
    sleep: Callable[[float], None] = time.sleep,
    rng: random.Random | None = None,
    **kwargs: Any,
):
    """Call ``fn(*args, **kwargs)``; on a ``retry_on`` exception, back off
    exponentially (``base_delay * 2**attempt``, capped at ``max_delay``, plus
    up to ``jitter`` fraction of random spread) and try again, at most
    ``attempts`` times total.  The final failure re-raises.

    Every failed attempt appends a JSONL record ``{time, description,
    attempt, attempts, error, delay}`` (see :func:`set_failure_log`).

    ``sleep``/``rng`` are injectable for deterministic tests.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    retry_on = tuple(retry_on)
    rng = rng or random.Random()

    for attempt in range(attempts):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            final = attempt == attempts - 1
            delay = 0.0
            if not final:
                delay = backoff_delay(attempt, base_delay=base_delay,
                                      max_delay=max_delay, jitter=jitter,
                                      rng=rng)
            _record({
                "time": time.time(),
                "description": description,
                "attempt": attempt + 1,
                "attempts": attempts,
                "error": f"{type(e).__name__}: {e}",
                "delay": round(delay, 4),
                "final": final,
            })
            if final:
                raise
            sleep(delay)
