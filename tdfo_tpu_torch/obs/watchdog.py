"""Stall watchdog — port of ``tdfo_tpu/obs/watchdog.py``.

A daemon thread wakes every ``timeout_s / 4`` seconds, appends the last
completed step (or shipped serving batch, ``label="serve"``) and its age
to a heartbeat JSONL, and when nothing completed within ``timeout_s`` logs
a warning with the Python stack of every live thread, so a wedged loop is
diagnosable from the log alone.  :meth:`StallWatchdog.set_status` merges
extra fields (the swap store's ``degraded`` / ``bad_deltas``) into every
record.  The port runs it on the serving path (``telemetry.stall_timeout_s``
on ``serve``).  It times the host loop, never device work.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback

logger = logging.getLogger(__name__)


class StallWatchdog:
    """Heartbeat writer + stall detector.

    ``beat(step)`` is called by the train loop each completed step; the
    daemon thread does everything else.  Re-arms after each stall so a
    recovered loop gets fresh detection.

    The serving frontend reuses the same machinery with ``label="serve"``
    (``beat`` per shipped scoring batch, so a wedged scorer dumps stacks
    through the identical path as a wedged train step), and publishes its
    degradation state via :meth:`set_status` — extra key/values merged into
    every heartbeat record (e.g. ``degraded``/``bad_deltas`` from the swap
    store's quarantine counter).
    """

    def __init__(self, heartbeat_path, timeout_s: float, *,
                 clock=time.monotonic, label: str = "train",
                 rotate_bytes: int = 0):
        self.path = os.fspath(heartbeat_path)
        self.timeout_s = float(timeout_s)
        self.rotate_bytes = int(rotate_bytes)
        self.label = str(label)
        self._clock = clock
        self._lock = threading.Lock()
        self._last_step = -1
        self._last_beat = clock()
        self._stalled = False
        self._status: dict = {}
        self.stall_events: list = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        open(self.path, "w").close()

    # ----------------------------------------------------------- loop API

    def beat(self, step: int) -> None:
        with self._lock:
            self._last_step = int(step)
            self._last_beat = self._clock()
            self._stalled = False

    def set_status(self, **kv) -> None:
        """Merge extra fields into every subsequent heartbeat record (the
        degraded-mode surface: ``set_status(degraded=True, bad_deltas=3)``)."""
        with self._lock:
            self._status.update(kv)

    def status(self) -> dict:
        with self._lock:
            return dict(self._status)

    def start(self) -> "StallWatchdog":
        if self.timeout_s > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="tdfo-stall-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s)
            self._thread = None

    # ------------------------------------------------------------ daemon

    def _write(self, rec: dict) -> None:
        from tdfo_tpu_torch.utils.logrotate import maybe_rotate_path

        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.rotate_bytes:
            # rotation happens between complete appends (closed file), so a
            # kill at any byte leaves whole lines in both generations
            maybe_rotate_path(self.path, self.rotate_bytes)

    def check(self) -> bool:
        """One watchdog pass (the daemon's body; callable from tests).
        Returns True when a stall was detected on this pass."""
        with self._lock:
            step, age = self._last_step, self._clock() - self._last_beat
            fresh_stall = age > self.timeout_s and not self._stalled
            if fresh_stall:
                self._stalled = True
            status = dict(self._status)
        self._write({"time": time.time(), "label": self.label,
                     "last_step": step, "step_age_s": age,
                     "stalled": age > self.timeout_s, **status})
        if fresh_stall:
            dump = self._dump_stacks()
            self.stall_events.append(
                {"last_step": step, "step_age_s": age})
            self._write({"time": time.time(), "kind": "stall",
                         "label": self.label, "last_step": step,
                         "step_age_s": age, "stacks": dump, **status})
            logger.warning(
                "STALL: no %s step completed in %.1fs (last step %d). "
                "Thread stacks:\n%s", self.label, age, step, dump)
        return fresh_stall

    def _dump_stacks(self) -> str:
        names = {t.ident: t.name for t in threading.enumerate()}
        parts = []
        for tid, frame in sys._current_frames().items():
            parts.append(f"--- thread {names.get(tid, '?')} ({tid}) ---\n"
                         + "".join(traceback.format_stack(frame)))
        return "\n".join(parts)

    def _run(self) -> None:
        interval = max(self.timeout_s / 4.0, 0.05)
        while not self._stop.wait(interval):
            self.check()
