"""Run observability: the ``MetricLogger`` JSONL sink and parameter tables.

Ports ``MetricLogger`` (``tdfo_tpu/train/trainer.py``) and ``param_summary``
(``tdfo_tpu/utils/summary.py``).  The JSONL schema is the reference's: one
JSON object per ``log`` call with the caller's keys plus ``time``; training
writes ``{epoch, step, train_loss, global_step}`` at the log cadence,
``{epoch, train_loss_epoch, steps, examples_per_sec, train_auc}`` per epoch
and ``{epoch, eval_loss, auc}`` per eval.  ``rotate_bytes > 0`` (``[telemetry]
log_rotate_bytes``) retires a full ``metrics.jsonl`` to ``metrics.jsonl.1``.
TensorBoard mirroring is not ported yet (``ROADMAP.md`` Queue A item 16b).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["MetricLogger", "param_summary"]


class MetricLogger:
    """stdout + ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str | Path | None = None, rotate_bytes: int = 0):
        self._f = None
        self._rotate_bytes = int(rotate_bytes)
        self._path: Path | None = None
        if log_dir is not None:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            self._path = Path(log_dir) / "metrics.jsonl"
            self._f = open(self._path, "a")

    def log(self, **record: Any) -> None:
        record = {
            k: (v.item() if isinstance(v, (np.generic, torch.Tensor))
                or (isinstance(v, np.ndarray) and v.ndim == 0) else v)
            for k, v in record.items()
        }
        record.setdefault("time", time.time())
        print(", ".join(
            f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in record.items() if k != "time"), flush=True)
        if self._f is not None:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()
            if self._rotate_bytes:
                from tdfo_tpu_torch.utils.logrotate import maybe_rotate_file

                self._f = maybe_rotate_file(self._f, self._path, self._rotate_bytes)

    def close(self) -> None:
        """Idempotent; later ``log`` calls fall back to stdout only."""
        if self._f is not None:
            self._f.close()
            self._f = None


def param_summary(module: torch.nn.Module | None = None,
                  tables: Mapping[str, torch.Tensor] | None = None,
                  coll=None, title: str = "model parameters") -> str:
    """Parameter table (name, shape, dtype, count) plus totals; fat-line
    arrays report their TRUE parameter count (lines x R x d) with the
    storage shape alongside."""
    rows = []
    if module is not None:
        for name, p in module.named_parameters():
            rows.append((name, tuple(p.shape), str(p.dtype).removeprefix("torch."),
                         p.numel()))
    for name, arr in sorted((tables or {}).items()):
        dt = str(arr.dtype).removeprefix("torch.")
        if coll is not None and arr.dim() == 3:
            d = coll.array_embedding_dim(name)
            r = coll.fat_layout_for(name).r
            rows.append((f"tables/{name} (fat {tuple(arr.shape)} incl. opt state)",
                         (arr.shape[0] * r, d), dt, arr.shape[0] * r * d))
        else:
            rows.append((f"tables/{name}", tuple(arr.shape), dt, arr.numel()))
    w = max((len(r[0]) for r in rows), default=10) + 2
    lines = [title, "-" * len(title)]
    for name, shape, dtype, count in rows:
        lines.append(f"{name:<{w}} {str(shape):<20} {dtype:<10} {count:>14,}")
    lines.append("-" * len(title))
    lines.append(f"{'total':<{w}} {'':<20} {'':<10} {sum(r[3] for r in rows):>14,}")
    return "\n".join(lines)
