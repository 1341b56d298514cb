"""Observability — port of ``tdfo_tpu/obs/``:

- ``counters``  — the step-counter collector the train steps emit
  device-computed diagnostics through; off, it dispatches nothing;
- ``events``    — the process-global build/capture recorder and card
  memory sampler appending to ``events.jsonl``;
- ``trace``     — span-based causal tracing (per-component
  ``trace-*.jsonl`` sinks carrying ``(replica, seq)`` / cycle / version /
  digest correlation ids);
- ``aggregate`` — the offline assembler over those sinks (timelines,
  Chrome-trace export, the fleet latency percentiles; ``launch obs``);
- ``watchdog``  — the stall watchdog (``heartbeat*.jsonl`` and a thread
  stack dump when no step or shipped batch completes in time).
"""

from tdfo_tpu_torch.obs import aggregate, counters, events, trace
from tdfo_tpu_torch.obs.watchdog import StallWatchdog

__all__ = ["aggregate", "counters", "events", "trace", "StallWatchdog"]
