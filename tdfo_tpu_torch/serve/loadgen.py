"""Load generation against the process fleet — port of
``tdfo_tpu/serve/loadgen.py`` (``LoadGenerator``, ``loadgen_from_config``,
``serve_fleet_from_config``).

:class:`LoadGenerator` drives the socket ingress with synthetic requests
whose ids follow a zipf popularity law (``[loadgen] zipf_a``; the same
numpy stream as the reference's for the same seed), under one of two
arrival disciplines: ``mode = "closed"`` keeps ``concurrency`` requests
outstanding (a reply funds the next), ``mode = "open"`` submits at
``rate_qps`` whether or not replies came back (queues grow past
saturation and admission control sheds, which a closed loop cannot show).
:meth:`LoadGenerator.knee` doubles the load per step and reports the last
step whose p99 still meets ``p99_slo_ms``.  Each step is also a
``loadgen_step`` trace span.  Wall time comes from ``obs/trace`` clock
stamps and pacing sleeps from an injectable ``sleep``, so tests run a
sweep without waiting.

``serve_fleet_from_config`` / ``loadgen_from_config`` are the ``launch
serve-fleet`` / ``launch loadgen`` bodies: restore the newest checkpoint
(a fresh init without one), export the bundle, ingest it into
``<log_dir>/bundle_store`` and stand up a
:class:`~tdfo_tpu_torch.serve.supervisor.ProcessFleet` of ``[serving]
replicas`` processes scoring on ``device`` (the card unless the caller
asks for the CPU).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np

from tdfo_tpu_torch.obs import trace as _trace
from tdfo_tpu_torch.obs.aggregate import percentile

__all__ = ["LoadGenerator", "loadgen_from_config", "serve_fleet_from_config"]

_POLL_S = 0.02  # ingress poll granularity between submissions


class LoadGenerator:
    """Drive an :class:`~tdfo_tpu_torch.serve.ingress.Ingress` (or any duck-typed
    ``submit``/``poll``/``inflight``/``completed`` surface) with zipf
    traffic."""

    def __init__(self, ingress, spec, vocab: Mapping[str, int],
                 cont_cols=(), *,
                 elapsed_ms: Callable[[float], float] | None = None,
                 sleep: Callable[[float], None] = time.sleep):
        self._ingress = ingress
        self.spec = spec
        self._vocab = dict(vocab)
        self._cont_cols = tuple(cont_cols)
        self._rng = np.random.default_rng(spec.seed)
        self._elapsed_ms = elapsed_ms or _trace.elapsed_ms
        self._sleep = sleep
        self._serial = 0

    def request(self) -> tuple[str, dict[str, np.ndarray]]:
        """One synthetic request: zipf-popular ids (rank r with probability
        ~ r^-a, folded into the vocab), uniform floats for the continuous
        columns."""
        i = self._serial
        self._serial += 1
        n = int(self.spec.rows_per_request)
        batch: dict[str, np.ndarray] = {}
        for c, v in self._vocab.items():
            ranks = self._rng.zipf(self.spec.zipf_a, size=n)
            batch[c] = ((ranks - 1) % max(int(v), 1)).astype(np.int32)
        for c in self._cont_cols:
            batch[c] = self._rng.random(n, dtype=np.float32)
        return f"lg{i}", batch

    # ----------------------------------------------------------- one run

    def run(self, *, requests: int | None = None,
            concurrency: int | None = None,
            rate_qps: float | None = None) -> dict[str, Any]:
        """Run one load step and return its stats record (also emitted as
        a ``loadgen_step`` span).  ``requests``/``concurrency``/``rate_qps``
        override the spec for knee sweeps."""
        spec = self.spec
        total = int(requests if requests is not None else spec.requests)
        conc = int(concurrency if concurrency is not None else
                   spec.concurrency)
        rate = float(rate_qps if rate_qps is not None else spec.rate_qps)
        ing = self._ingress
        lat0 = len(ing.latencies_ms)
        shed0, fail0, done0 = ing.sheds, ing.failures, len(ing.completed)
        submitted = 0
        t0 = _trace.clock()

        def done() -> int:
            return len(ing.completed) - done0

        if spec.mode == "closed":
            while done() < total:
                while submitted < total and ing.inflight() < conc:
                    rid, batch = self.request()
                    ing.submit(rid, batch)
                    submitted += 1
                ing.poll(_POLL_S if ing.inflight() else 0.0)
                if not ing.inflight() and submitted >= total \
                        and done() < total:
                    break  # every remaining request died with a connection
        else:  # open loop: fixed-rate arrivals, replies never gate sends
            while submitted < total or (ing.inflight() and done() < total):
                if submitted < total:
                    target_ms = submitted * 1000.0 / rate
                    ahead_ms = target_ms - self._elapsed_ms(t0)
                    if ahead_ms <= 0.0:
                        rid, batch = self.request()
                        ing.submit(rid, batch)
                        submitted += 1
                        continue
                    wait_s = min(ahead_ms / 1000.0, _POLL_S)
                else:
                    wait_s = _POLL_S
                ing.poll(wait_s)

        wall_s = self._elapsed_ms(t0) / 1000.0
        lat = list(ing.latencies_ms[lat0:])
        n_done = done()
        stats = {
            "mode": spec.mode,
            "offered": total,
            "concurrency": conc if spec.mode == "closed" else None,
            "offered_qps": rate if spec.mode == "open" else None,
            "completed": n_done,
            "achieved_qps": (n_done / wall_s) if wall_s > 0 else 0.0,
            "p50_ms": percentile(lat, 50),
            "p99_ms": percentile(lat, 99),
            "shed": ing.sheds - shed0,
            "failed": ing.failures - fail0,
            "p99_slo_ms": spec.p99_slo_ms,
            "slo_ok": bool(lat) and percentile(lat, 99) <= spec.p99_slo_ms,
        }
        _trace.emit("loadgen", "loadgen_step", **stats)
        return stats

    # -------------------------------------------------------------- knee

    def knee(self, *, steps: int = 4) -> dict[str, Any]:
        """Sweep the load axis doubling per step and locate the
        latency/throughput knee: the last step whose p99 still met
        ``p99_slo_ms``.  Closed mode doubles concurrency from 1; open mode
        doubles the rate from ``rate_qps / 2**(steps-1)`` up to
        ``rate_qps``."""
        spec = self.spec
        records = []
        for s in range(int(steps)):
            if spec.mode == "closed":
                rec = self.run(concurrency=2 ** s)
            else:
                rec = self.run(
                    rate_qps=spec.rate_qps / float(2 ** (steps - 1 - s)))
            records.append(rec)
        knee = None
        for rec in records:
            if rec["slo_ok"]:
                knee = rec
        return {"steps": records, "knee": knee}


def _build_process_fleet(config, log_dir, device):
    """Shared ``serve-fleet`` / ``loadgen`` preamble: export a bundle
    (restoring the newest checkpoint when there is one), ingest it into a
    :class:`~tdfo_tpu_torch.serve.swap.BundleStore`, and spawn a
    :class:`~tdfo_tpu_torch.serve.supervisor.ProcessFleet` of ``[serving]
    replicas`` processes following it on ``device``."""
    from tdfo_tpu_torch.serve.frontend import _column_vocab, restore_and_export
    from tdfo_tpu_torch.serve.supervisor import ProcessFleet
    from tdfo_tpu_torch.serve.swap import BundleStore

    if config.model not in ("twotower", "dlrm"):
        raise ValueError(
            f"the process fleet serves the CTR family (twotower/dlrm), not "
            f"{config.model!r}")
    trainer, step, out_dir, cat_cols, cont_cols = restore_and_export(
        config, log_dir=log_dir, device=device)
    base = out_dir.parent
    store = BundleStore(base / "bundle_store")
    if store.recover() is None:
        store.ingest_full(out_dir)
    fleet = ProcessFleet(
        store, config, workdir=base, logger=trainer.logger,
        request_log_root=(base / "request_log"
                          if config.serving.log_features else None),
        device=str(trainer.device))
    return trainer, fleet, _column_vocab(config, cat_cols), cont_cols, \
        step, out_dir


def loadgen_from_config(config, *, log_dir: str | Path | None = None,
                        knee_steps: int = 4, device="cuda") -> dict[str, Any]:
    """The ``python -m tdfo_tpu_torch.launch loadgen`` body: stand the process
    fleet up and sweep the ``[loadgen]`` traffic through the socket
    ingress.  Returns the knee report."""
    trainer, fleet, vocab, cont_cols, step, out_dir = \
        _build_process_fleet(config, log_dir, device)
    try:
        fleet.sync()
        gen = LoadGenerator(fleet.ingress, config.loadgen, vocab, cont_cols)
        report = gen.knee(steps=knee_steps)
    finally:
        fleet.close()
        trainer.logger.close()
    report["replicas"] = int(config.serving.replicas)
    report["bundle"] = str(out_dir)
    report["step"] = int(step)
    return report


def serve_fleet_from_config(config, *, log_dir: str | Path | None = None,
                            n_requests: int = 64,
                            device="cuda") -> dict[str, Any]:
    """The ``python -m tdfo_tpu_torch.launch serve-fleet`` body: the process twin
    of ``serve`` with ``[serving] replicas > 1`` — same synthetic ragged
    trace, but routed through the P2C ingress to real replica processes.
    Returns the latency/throughput stats dict (printed by ``launch``)."""
    trainer, fleet, vocab, cont_cols, step, out_dir = \
        _build_process_fleet(config, log_dir, device)
    spec = config.serving
    rng = np.random.default_rng(config.seed)
    label_rng = np.random.default_rng(config.seed + 1)
    hi = min(spec.max_batch, spec.buckets[0])
    requests = []
    for i in range(n_requests):
        n = int(rng.integers(1, hi + 1))
        batch: dict[str, np.ndarray] = {
            c: rng.integers(0, v, size=n, dtype=np.int32)
            for c, v in vocab.items()}
        for c in cont_cols:
            batch[c] = rng.random(n, dtype=np.float32)
        if spec.log_features:
            batch["label"] = label_rng.integers(0, 2, size=n, dtype=np.int8)
        requests.append((f"req{i}", batch))
    try:
        fleet.sync()
        t0 = _trace.clock()
        results = fleet.run(requests)
        wall_s = _trace.elapsed_ms(t0) / 1000.0
        lat = list(fleet.ingress.latencies_ms)
        stats = {
            "requests": len(results),
            "answered": sum(1 for v in results.values() if v is not None),
            "p50_ms": percentile(lat, 50),
            "p99_ms": percentile(lat, 99),
            "shed": fleet.ingress.sheds,
            "failed": fleet.ingress.failures,
            "replicas": len(fleet.alive_ids()),
            "version": int(fleet.store.current_version() or 0),
            "qps": (len(results) / wall_s) if wall_s > 0 else float("inf"),
        }
        if spec.log_features:
            stats["request_log"] = str(
                Path(log_dir or config.checkpoint_dir or ".") / "request_log")
    finally:
        fleet.close()
        trainer.logger.close()
    stats["bundle"] = str(out_dir)
    stats["step"] = int(step)
    return stats
