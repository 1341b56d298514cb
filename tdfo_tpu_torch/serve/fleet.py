"""Several serving frontends over one shared bundle store — port of
``tdfo_tpu/serve/fleet.py`` (``ReplicaFrontend``, ``ServingFleet``, for
the CTR and the sequence family).

Each :class:`ReplicaFrontend` owns its own
:class:`~tdfo_tpu_torch.serve.frontend.MicroBatcher`, its own scorer on
the fleet's ``device`` (the card unless the caller asks for the CPU; under
a ``mesh`` each rank scores on its replicated parameters, as
``serve/scoring.py`` does) and its own request-log directory
(``<root>/replica-<k>``), while all replicas follow the store's shared
``CURRENT`` / ``CANARY`` pointers.  Replicas only read the pointers: one
writer mutates the store, and :meth:`ServingFleet.sync` reloads a replica
when the (version, digest) it should serve changed.  A canary member
follows ``CANARY`` while one is pending; everyone else stays on
``CURRENT``.

Faults (``utils/faults.py``): ``set_score_skew`` serves a named digest
with a feature heuristic (healthy bytes, wrong logits),
``set_score_slow`` scores it through a ``slow_score_ms`` sleep, and
``kill_replica_nth`` drops one replica dead at its first canary watch.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable

import numpy as np

from tdfo_tpu_torch.obs import trace as _trace
from tdfo_tpu_torch.serve.export import load_bundle
from tdfo_tpu_torch.serve.frontend import MicroBatcher, _host_scores
from tdfo_tpu_torch.serve.scoring import make_scorer
from tdfo_tpu_torch.serve.swap import BundleStore, _version_name
from tdfo_tpu_torch.train.metrics import binary_auc, ranking_auc
from tdfo_tpu_torch.utils import faults as _faults

__all__ = ["ReplicaFrontend", "ServingFleet"]


class ReplicaFrontend:
    """One serving replica: a micro-batcher plus the pointer-follow logic.

    ``sync`` is the whole replica lifecycle: read the pointer this replica
    follows (``CANARY`` for canary members while one is pending, else
    ``CURRENT``), and when the ``(version, digest)`` pair changed, load
    the bundle (digest-verified), build a fresh scorer, and hot-swap the
    batcher onto it.  ``skew_digests`` injects the training/serving-skew
    fault: for bundles with those digests the scorer is replaced by a
    feature heuristic (negated first continuous column), so the replica
    serves confidently wrong logits from a bundle whose bytes are perfect.
    """

    def __init__(self, replica_id: int, store: BundleStore, serving_spec,
                 *, mesh=None, logger=None, request_log_root=None,
                 canary_member: bool = False, device="cuda"):
        self.replica_id = int(replica_id)
        self.store = store
        self.spec = serving_spec
        self.mesh = mesh
        self.device = device
        self.canary_member = bool(canary_member)
        self._logger = logger
        self.batcher: MicroBatcher | None = None
        # (version, digest, skewed, slow): fault membership is part of the
        # served identity — a restart lineage may sync onto a pending
        # canary BEFORE the supervisor re-arms the skew/slow fault, and
        # the later sync must then reload the same bytes with the faulted
        # scorer or the two lineages diverge.
        self._served: tuple[int, str, bool, bool] | None = None
        self._score_fn: Callable | None = None
        self._request_log = None
        if request_log_root is not None:
            from tdfo_tpu_torch.data.replay import RequestLog, replica_log_dir

            self._request_log = RequestLog(
                replica_log_dir(request_log_root, self.replica_id),
                segment_bytes=serving_spec.log_segment_bytes)

    # ------------------------------------------------------------- follow

    def _target_pointer(self) -> dict | None:
        if self.canary_member:
            can = self.store._read_pointer("CANARY")
            cur = self.store.current_version()
            if can is not None and (cur is None or can["version"] > cur):
                return can
        return self.store._read_pointer("CURRENT")

    def sync(self, skew_digests: frozenset[str] = frozenset(),
             slow_digests: frozenset[str] = frozenset()) -> int | None:
        """Follow this replica's pointer; reload iff (version, digest,
        skewed, slow) changed.  Returns the version now being served
        (None = empty store, nothing to serve yet)."""
        ptr = self._target_pointer()
        if ptr is None:
            return None
        skewed = str(ptr["digest"]) in skew_digests
        slow = str(ptr["digest"]) in slow_digests
        key = (int(ptr["version"]), str(ptr["digest"]), skewed, slow)
        if key == self._served:
            return key[0]
        version = key[0]
        bdir = self.store.versions / _version_name(version)
        bundle = load_bundle(bdir, verify=True)
        scorer = make_scorer(bundle, mesh=self.mesh, device=self.device)
        cache_probe: Callable[[], int] | None = scorer.score_cache_size
        if skewed:
            # training/serving skew stand-in: healthy bytes, wrong logits.
            # No model call — deterministic, and independent of how well
            # the real model fits.  The seq family has no continuous
            # columns; its heuristic negates the candidate-id panel (same
            # [n, C] output shape as the honest scorer).
            skew_col = (scorer.cont_columns[0] if scorer.cont_columns
                        else "cands")

            def score_fn(batch, _col=skew_col):
                return -np.asarray(batch[_col], np.float32)

            cache_probe = None  # no model behind the heuristic
        else:
            score_fn = scorer.score
        if slow:
            # latency-regression stand-in (slow_canary_at_cycle): correct
            # logits, slow scorer — only replicas serving THIS digest pay
            # the sleep, so heartbeat p99s diverge by cohort and the
            # [online] max_p99_regression_ms verdict term has a signal
            inner = score_fn

            def score_fn(batch, _inner=inner):
                inj = _faults.active()
                if inj is not None:
                    inj.slow_score_sleep()
                return _inner(batch)

        self._score_fn = score_fn
        # seq requests carry [n, max_len] history panels, so the right fill
        # thresholds are the (smaller) [serving] history_buckets when set
        buckets = ((self.spec.history_buckets or self.spec.buckets)
                   if scorer.model == "bert4rec" else self.spec.buckets)
        if self.batcher is None:
            self.batcher = MicroBatcher(
                score_fn, buckets=buckets,
                max_batch=self.spec.max_batch,
                batch_deadline_ms=self.spec.batch_deadline_ms,
                logger=self._logger, program_cache_size=cache_probe,
                max_queue=self.spec.max_queue,
                shed_policy=self.spec.shed_policy,
                request_log=self._request_log)
            self.batcher.replica = self.replica_id
            self.batcher._version = version
            self.batcher._digest = key[1]
        else:
            self.batcher.swap(score_fn, version=version, digest=key[1],
                              program_cache_size=cache_probe)
        self._served = key
        # the freshness-lag anchor: when a version first goes live on a
        # replica outside a promote flip (obs/aggregate.py uses the
        # earliest of either)
        _trace.emit("fleet", "replica_sync", replica=self.replica_id,
                    version=version, digest=key[1],
                    canary=self.canary_member, skewed=skewed, slow=slow)
        return version

    # -------------------------------------------------------------- serve

    def score_direct(self, feats: dict[str, np.ndarray]) -> np.ndarray:
        """Score one batch on the replica's CURRENT scorer, bypassing the
        micro-batcher — the heartbeat path, which must not append to the
        request log (scoring our own replayed traffic back into the log
        would feed the gate its own output).  The scores come back on the
        host."""
        if self._score_fn is None:
            raise RuntimeError(
                f"replica {self.replica_id} has never synced — no scorer")
        return _host_scores(
            self._score_fn({k: np.asarray(v) for k, v in feats.items()}))

    def version(self) -> int | None:
        return None if self._served is None else self._served[0]

    def close(self) -> None:
        if self._request_log is not None:
            self._request_log.close()
            self._request_log = None


class ServingFleet:
    """N replicas following one store, plus the canary-watch instrumentation.

    The first ``max(1, int(n * canary_fraction))`` replica ids are the
    canary cohort — a fixed, deterministic membership, same on every
    restart lineage.  ``heartbeat`` is the per-replica health sample the
    gatekeeper consumes: held-out AUC plus a wall-clock latency figure per
    alive replica, tagged with cohort membership.  Dead replicas
    (``kill_replica_nth``) stop syncing, serving and heartbeating but are
    NOT forgotten: their request logs remain merged-replay inputs, so
    exactly-once accounting survives replica death.
    """

    def __init__(self, store: BundleStore, config, *, mesh=None,
                 logger=None, request_log_root=None, device="cuda"):
        n = int(config.serving.replicas)
        if n < 1:
            raise ValueError(f"serving.replicas must be >= 1, got {n}")
        frac = float(config.online.canary_fraction)
        self.n_canary = max(1, int(n * frac)) if n > 1 else 0
        self.replicas = [
            ReplicaFrontend(
                k, store, config.serving, mesh=mesh, logger=logger,
                request_log_root=request_log_root,
                canary_member=k < self.n_canary, device=device)
            for k in range(n)
        ]
        self.store = store
        self._dead: set[int] = set()
        self._skew_digests: set[str] = set()
        self._slow_digests: set[str] = set()
        self._warmed: set[tuple] = set()
        self._logger = logger

    # ------------------------------------------------------------ members

    def alive(self) -> list[ReplicaFrontend]:
        return [r for r in self.replicas if r.replica_id not in self._dead]

    def alive_canaries(self) -> list[ReplicaFrontend]:
        return [r for r in self.alive() if r.canary_member]

    def mark_canary_watch(self) -> None:
        """Consult the ``kill_replica_nth`` fault at a canary watch round:
        replica ``nth - 1`` drops dead (in-process — its scorer and
        batcher stop participating; its request log stays on disk for the
        merged replay)."""
        inj = _faults.active()
        if inj is not None and inj.replica_kill_due():
            victim = int(inj.spec.kill_replica_nth) - 1
            if 0 <= victim < len(self.replicas):
                self._dead.add(victim)
                if self._logger is not None:
                    self._logger.log(event="replica_dead", replica=victim,
                                     reason="kill_replica_nth")

    def set_score_skew(self, digest: str) -> None:
        """Arm the training/serving-skew fault for the bundle with this
        digest: any replica that syncs onto it serves heuristic logits.
        Keyed by DIGEST, not version — rollback deletes the bad candidate
        and the next cycle REUSES its version number for different
        bytes, which must serve honestly."""
        self._skew_digests.add(str(digest))

    def set_score_slow(self, digest: str) -> None:
        """Arm the latency-regression fault (``slow_canary_at_cycle``) for
        the bundle with this digest: any replica that syncs onto it scores
        through a ``slow_score_ms`` host sleep.  Digest-keyed for the same
        reason as :meth:`set_score_skew` — rollback reuses version numbers
        for different bytes, which must serve at full speed."""
        self._slow_digests.add(str(digest))

    # -------------------------------------------------------------- sync

    def sync(self) -> dict[int, int | None]:
        """Point every alive replica at its pointer; returns the served
        version per replica id."""
        skew = frozenset(self._skew_digests)
        slow = frozenset(self._slow_digests)
        return {r.replica_id: r.sync(skew, slow) for r in self.alive()}

    def versions(self) -> dict[int, int | None]:
        return {r.replica_id: r.version() for r in self.alive()}

    # ---------------------------------------------------------- heartbeat

    def heartbeat(self, feats: dict[str, np.ndarray],
                  labels: np.ndarray | None) -> list[dict[str, Any]]:
        """One health sample per alive replica on a held-out slice:
        ``{replica, version, auc, ms, canary, queue_depth, batch_fill}``.
        ``labels = None`` is the seq family: scores are [n, C] candidate
        panels with the positive in column 0, judged by ``ranking_auc``
        instead of the labelled ``binary_auc``
        (the saturation pair mirrored from the replica's micro-batcher).
        Fresh arrays per call.  Each
        sample is also emitted as a ``heartbeat`` trace span: the ``ms``
        samples are what the offline p50/p99 histograms and the online
        ``max_p99_regression_ms`` verdict term are computed from.

        A replica's FIRST sample on a freshly-synced scorer is preceded by
        one unmeasured warm-up score: the first call's set-up (allocator,
        GEMM algorithm choice) is a one-time cost
        the canary cohort would otherwise pay on EVERY cycle (its bundle
        is always new) while the stable cohort never does — a constant
        false p99 regression that would mask or mimic real slowdowns."""
        out = []
        for r in self.alive():
            if (r.replica_id, r._served) not in self._warmed:
                self._warmed.add((r.replica_id, r._served))
                r.score_direct({k: np.array(v) for k, v in feats.items()})
            t0 = _trace.clock()
            scores = r.score_direct(
                {k: np.array(v) for k, v in feats.items()})
            ms = _trace.elapsed_ms(t0)
            rec: dict[str, Any] = {
                "replica": r.replica_id, "version": r.version(),
                "auc": (ranking_auc(scores) if labels is None
                        else binary_auc(labels, scores)), "ms": ms,
                "canary": r.canary_member,
                # trace-clock stamp for staleness eviction: a dead replica
                # keeps its last queue_depth/batch_fill forever, so the
                # balancer must age records out — serve/ingress.py treats
                # anything older than [serving] heartbeat_stale_ms as dead
                # (freshness = _trace.elapsed_ms(hb_at), never a raw clock
                # difference).  In-process fleets stamp at the sample;
                # PROCESS fleets re-stamp at ingress receipt, because
                # monotonic clocks are not comparable across processes.
                "hb_at": _trace.clock(),
            }
            if r.batcher is not None:
                rec["queue_depth"] = r.batcher.last_queue_depth
                rec["batch_fill"] = r.batcher.last_batch_fill
            _trace.emit("fleet", "heartbeat", **rec)
            out.append(rec)
        return out

    # -------------------------------------------------------------- serve

    def probe_each(self, requests) -> dict[int, dict[Any, np.ndarray]]:
        """Run the same request trace through EVERY alive replica's
        micro-batcher — the bitwise fleet-convergence probe.  Each replica
        gets its own copy of the trace (batchers log)."""
        out = {}
        for r in self.alive():
            if r.batcher is None:
                continue
            trace = [(rid, {k: np.array(v) for k, v in batch.items()})
                     for rid, batch in requests]
            out[r.replica_id] = dict(r.batcher.run(trace))
        return out

    def run(self, requests) -> dict[Any, np.ndarray]:
        """Round-robin a request trace across alive replicas — the load-
        balancer path the fleet quickstart demonstrates."""
        alive = [r for r in self.alive() if r.batcher is not None]
        if not alive:
            raise RuntimeError("no alive, synced replica to serve on")
        results: dict[Any, np.ndarray] = {}
        for i, (rid, batch) in enumerate(requests):
            r = alive[i % len(alive)]
            r.batcher.submit(rid, batch)
            r.batcher.poll()
        for r in alive:
            r.batcher.drain()
            results.update(r.batcher.results)
        return results

    def close(self) -> None:
        for r in self.replicas:
            r.close()
