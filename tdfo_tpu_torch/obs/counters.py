"""Step counters — port of ``tdfo_tpu/obs/counters.py``.

The steps are built from layered helpers (the sparse step's lookups and
updates, the update cache's math, the dense step) that would each need a
threaded-through accumulator to report diagnostics.  Instead, emission
sites call :func:`emit` unconditionally and a *collector*, a plain dict
pushed onto a module-level stack while a step runs, decides whether
anything happens:

- no collector open (the default, ``[telemetry] counters = false``):
  ``emit`` returns at once without calling its value thunk, so the step
  dispatches exactly the operations it would with no telemetry code at all
  (``tests/test_torch_telemetry.py`` counts them);
- a collector open: the thunk runs and its value lands in the dict as a
  0-dim f32 tensor on the step's device.  The trainer's step wrapper
  returns the dict beside the loss, so counter values stay on the device
  and are fetched with the losses at the log cadence: no extra host sync.
  Under ``train/step.py::CudaGraphStep`` the collector opens inside the
  captured function, so the counters are outputs of the graph (static
  buffers the replays rewrite), never tensors made at replay.

:func:`suppress` disables emission for a region and :func:`scope`
prefixes the names emitted in it (``emb/<array>/cache_hit_rows``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Union

import torch

__all__ = ["collect", "emit", "enabled", "scope", "suppress"]

# the open collectors; None marks a suppressed region
_STACK: list = []
_PREFIX: list = []


def enabled() -> bool:
    """True when the innermost region has a live collector."""
    return bool(_STACK) and _STACK[-1] is not None


def emit(name: str, value: Union[Callable, object]) -> None:
    """Record ``value`` under ``name`` in the open collector, if any.
    ``value`` may be a zero-argument thunk, called only when a collector is
    open.  Values become 0-dim f32 tensors (one dtype and shape for every
    counter, so a window's counters fetch in one transfer)."""
    if not enabled():
        return
    if callable(value):
        value = value()
    t = torch.as_tensor(value).detach()
    _STACK[-1]["".join(_PREFIX) + name] = t.to(torch.float32).reshape(())


@contextlib.contextmanager
def collect():
    """Open a collector; yields the dict that ``emit`` fills."""
    out: dict = {}
    _STACK.append(out)
    try:
        yield out
    finally:
        _STACK.pop()


@contextlib.contextmanager
def suppress():
    """Disable emission for the enclosed region."""
    if not _STACK:
        yield
        return
    _STACK.append(None)
    try:
        yield
    finally:
        _STACK.pop()


@contextlib.contextmanager
def scope(prefix: str):
    """Prefix counter names emitted in the enclosed region."""
    _PREFIX.append(prefix)
    try:
        yield
    finally:
        _PREFIX.pop()
