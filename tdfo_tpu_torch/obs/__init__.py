"""Observability — port of ``tdfo_tpu/obs/`` for the serving tier:

- ``trace``     — span-based causal tracing (per-component
  ``trace-*.jsonl`` sinks carrying ``(replica, seq)`` / version / digest
  correlation ids);
- ``aggregate`` — the offline assembler over those sinks (timelines,
  Chrome-trace export, the fleet latency percentiles);
- ``watchdog``  — the stall watchdog (``heartbeat*.jsonl`` and a thread
  stack dump when no step or shipped batch completes in time).

``counters``, ``events`` and ``launch obs`` are not ported yet
(``ROADMAP.md`` item 16).
"""

from tdfo_tpu_torch.obs import aggregate, trace
from tdfo_tpu_torch.obs.watchdog import StallWatchdog

__all__ = ["aggregate", "trace", "StallWatchdog"]
