"""Micro-batching request frontend and the ``launch.py serve`` body — port
of ``tdfo_tpu/serve/frontend.py`` (``MicroBatcher``, ``serve_from_config``,
``_column_vocab``).

:class:`MicroBatcher` turns ragged little requests into a few fixed
shapes, as the reference's does:

* requests queue until ``max_batch`` rows are pending (ship full) or the
  OLDEST request's ``batch_deadline_ms`` expires (ship partial);
* every shipped batch pads up to the smallest of the ``buckets`` that
  fits, so the scorer runs at most ``len(buckets)`` batch shapes (checked
  at every ship when the scorer reports its count);
* per-request latency goes to the metrics JSONL
  (``utils/summary.MetricLogger``) with a p50/p99 summary;
* overload sheds instead of queueing without bound: with ``max_queue``
  set, an arrival first evicts pending requests already past the deadline
  (oldest first), then displaces the oldest survivor
  (``shed_policy = "oldest"``) or bounces itself (``"reject"``);
* :meth:`MicroBatcher.swap` flips to a new scorer after draining the
  accepted requests on the old one.

The clock is injectable (default ``time.monotonic``), so tests drive the
deadlines.

Under a process group (``launch serve`` through ``torch.distributed.run``)
every rank is one process of the same program: rank 0 gathers the
restored state into the single-device layout and writes the bundle, the
others wait and load it; each rank scores the same seeded request trace
on its replicated parameters (only rank 0 logs), and the corpus shards
over the mesh's ``data`` axis (``serve/corpus.py``, ``serve/retrieval.py``).

The batcher also takes the replayable request log (``[serving]
log_features``: ``data/replay.py::RequestLog``, a ``label`` column logged
and stripped before scoring) and the serving watchdog
(``telemetry.stall_timeout_s``: a beat per shipped batch), and sleeps
``[faults] slow_score_ms`` per shipped batch.  ``[serving] replicas > 1``
serves the trace through an in-process ``serve/fleet.py::ServingFleet``
following a ``serve/swap.py::BundleStore``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch

from tdfo_tpu_torch.obs import trace as _trace

__all__ = ["MicroBatcher", "serve_from_config"]


def _host_scores(scores) -> np.ndarray:
    """Scores on the host (a tensor from any device; bf16 widens to f32)."""
    if isinstance(scores, torch.Tensor):
        from tdfo_tpu_torch.interop import to_numpy

        return to_numpy(scores)
    return np.asarray(scores)


class MicroBatcher:
    """Deadline/bucket batch assembly around one ``score_fn``.

    ``score_fn(batch) -> [B, ...] scores`` must accept any batch size in
    ``buckets``.  Requests are dicts of aligned ``[n, ...]`` columns;
    results come back unpadded, ``n`` rows per request (``None`` for a
    shed request).  Scores come to the host before a request's latency is
    taken, so latencies measure answers, not launches.  ``watchdog``: a
    ``obs/watchdog.StallWatchdog`` beaten per shipped batch;
    ``request_log``: a ``data/replay.RequestLog`` every served request's
    features (and its ``label`` column, stripped before scoring) and every
    shed are appended to."""

    def __init__(
        self,
        score_fn: Callable,
        *,
        buckets: tuple[int, ...],
        max_batch: int,
        batch_deadline_ms: float,
        logger=None,
        clock: Callable[[], float] = time.monotonic,
        program_cache_size: Callable[[], int] | None = None,
        max_queue: int = 0,
        shed_policy: str = "oldest",
        watchdog=None,
        request_log=None,
    ):
        buckets = tuple(buckets)
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError("buckets must be non-empty, strictly increasing")
        if max_batch > buckets[-1]:
            raise ValueError(
                f"max_batch {max_batch} does not fit buckets[-1] {buckets[-1]}")
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0 (0 = unbounded), "
                             f"got {max_queue}")
        if shed_policy not in ("oldest", "reject"):
            raise ValueError(f"shed_policy must be 'oldest' or 'reject', "
                             f"got {shed_policy!r}")
        self._score = score_fn
        self._buckets = buckets
        self._max_batch = int(max_batch)
        self._deadline_s = float(batch_deadline_ms) / 1000.0
        self._logger = logger
        self._clock = clock
        # the bounded-program invariant, checked at every ship when the
        # scorer reports how many batch shapes it has run
        self._cache_size = program_cache_size
        self._max_queue = int(max_queue)  # pending REQUESTS cap, 0 = off
        self._shed_policy = shed_policy
        self._watchdog = watchdog
        self._request_log = request_log
        self._labels: dict[Any, np.ndarray] = {}
        self._ships = 0
        self._pending: list[tuple[Any, dict[str, np.ndarray], int, float]] = []
        self._pending_rows = 0
        self.results: dict[Any, np.ndarray | None] = {}
        self.latencies_ms: list[float] = []
        # (rows, padded) per shipped batch
        self.shipped: list[tuple[int, int]] = []
        self.shed: list[tuple[Any, str]] = []  # (request_id, reason)
        self.swaps: list[dict[str, Any]] = []
        self._version: Any = None  # bundle version being served
        self._digest: Any = None  # and its digest (trace identity)
        # the fleet replica this batcher serves for (0 alone)
        self.replica = 0
        # saturation of the last shipped batch: the fleet heartbeat and
        # the process fleet's score replies carry them to the balancer
        self.last_queue_depth = 0
        self.last_batch_fill = 0.0
        self._swapping = False
        self._under_swap_ms: list[float] = []

    # ------------------------------------------------------------- intake

    def submit(self, request_id: Any, batch: Mapping[str, np.ndarray]) -> None:
        """Queue one request; ships (possibly several) full batches as soon
        as ``max_batch`` rows are pending."""
        cols = {k: np.asarray(v) for k, v in batch.items()}
        n = len(next(iter(cols.values())))
        if any(len(v) != n for v in cols.values()):
            raise ValueError(f"request {request_id!r}: ragged columns")
        if self._request_log is not None:
            # feedback column: logged for replay, stripped before scoring
            label = cols.pop("label", None)
            if label is not None:
                self._labels[request_id] = label
        if n > self._max_batch:
            raise ValueError(
                f"request {request_id!r} has {n} rows > max_batch "
                f"{self._max_batch}; split it upstream")
        if self._max_queue and len(self._pending) >= self._max_queue:
            # admission control: shed already-doomed requests first (past
            # the deadline they were promised), then apply the policy
            now = self._clock()
            while (self._pending and len(self._pending) >= self._max_queue
                   and now - self._pending[0][3] >= self._deadline_s):
                self._shed_oldest("past_deadline")
            if len(self._pending) >= self._max_queue:
                if self._shed_policy == "reject":
                    self._record_shed(request_id, n, self._clock(), "rejected")
                    return
                self._shed_oldest("displaced")
        self._pending.append((request_id, cols, n, self._clock()))
        self._pending_rows += n
        while self._pending_rows >= self._max_batch:
            self._ship()

    def _shed_oldest(self, reason: str) -> None:
        rid, _, n, t0 = self._pending.pop(0)
        self._pending_rows -= n
        self._record_shed(rid, n, t0, reason)

    def _record_shed(self, rid: Any, n: int, t0: float, reason: str) -> None:
        self.results[rid] = None  # the caller sees the outcome, not a KeyError
        self.shed.append((rid, reason))
        if self._request_log is not None:
            self._labels.pop(rid, None)
            # never scored: the record carries no feature payload
            self._request_log.append({
                "event": "serve_request", "request": str(rid), "rows": n,
                "outcome": "shed", "shed_reason": reason,
                "version": self._version})
        if self._logger is not None:
            self._logger.log(event="serve_request", request=str(rid), rows=n,
                             batch_rows=0, padded=0, queue_depth=len(self._pending),
                             batch_fill=0.0,
                             latency_ms=(self._clock() - t0) * 1000.0,
                             outcome="shed", shed_reason=reason,
                             under_swap=self._swapping, version=self._version)

    def poll(self) -> None:
        """Ship a PARTIAL batch iff the oldest pending request's deadline
        has expired (deadline 0 ships on every poll)."""
        if not self._pending:
            return
        if self._clock() - self._pending[0][3] >= self._deadline_s:
            self._ship()

    def drain(self) -> None:
        """Flush everything still pending (shutdown path)."""
        while self._pending:
            self._ship()

    # ----------------------------------------------------------- shipping

    def _bucket(self, rows: int) -> int:
        for b in self._buckets:
            if b >= rows:
                return b
        raise ValueError(f"batch of {rows} rows exceeds buckets[-1] {self._buckets[-1]}")

    def _ship(self) -> None:
        take: list[tuple[Any, dict[str, np.ndarray], int, float]] = []
        rows = 0
        # whole requests only, first come first served, up to max_batch
        while self._pending and (
                not take or rows + self._pending[0][2] <= self._max_batch):
            item = self._pending.pop(0)
            take.append(item)
            rows += item[2]
        self._pending_rows -= rows
        padded = self._bucket(rows)
        batch: dict[str, np.ndarray] = {}
        for k in take[0][1]:
            col = np.concatenate([cols[k] for _, cols, _, _ in take])
            batch[k] = np.pad(col, [(0, padded - rows)] + [(0, 0)] * (col.ndim - 1))
        from tdfo_tpu_torch.utils import faults

        inj = faults.active()
        if inj is not None:
            inj.maybe_slow_score()
        scores = _host_scores(self._score(batch))[:rows]
        self.shipped.append((rows, padded))
        self._ships += 1
        if self._watchdog is not None:
            self._watchdog.beat(self._ships)
        if self._cache_size is not None:
            n_progs = self._cache_size()
            if n_progs > len(self._buckets):
                raise RuntimeError(
                    f"bounded-program invariant violated: the scorer has run "
                    f"{n_progs} batch shapes for {len(self._buckets)} "
                    f"buckets — a non-bucket batch shape reached score_fn")
        done = self._clock()
        depth = self.last_queue_depth = len(self._pending)
        fill = self.last_batch_fill = rows / padded
        off = 0
        for rid, cols, n, t0 in take:
            self.results[rid] = scores[off:off + n]
            off += n
            latency_ms = (done - t0) * 1000.0
            self.latencies_ms.append(latency_ms)
            if self._swapping:
                self._under_swap_ms.append(latency_ms)
            if self._request_log is not None:
                feats = {k: v.tolist() for k, v in cols.items()}
                label = self._labels.pop(rid, None)
                if label is not None:
                    feats["label"] = label.tolist()
                seq = self._request_log.append({
                    "event": "serve_request", "request": str(rid),
                    "rows": n, "outcome": "ok", "features": feats,
                    "under_swap": self._swapping, "version": self._version,
                    "latency_ms": latency_ms})
                # (replica, seq) names the request; (version, digest) what
                # served it
                _trace.emit(
                    "frontend", "serve_request", replica=self.replica,
                    seq=seq, version=self._version, digest=self._digest,
                    rows=n, latency_ms=round(latency_ms, 3),
                    queue_depth=depth, batch_fill=round(fill, 4))
            if self._logger is not None:
                self._logger.log(event="serve_request", request=str(rid),
                                 rows=n, batch_rows=rows, padded=padded,
                                 queue_depth=depth, batch_fill=fill,
                                 latency_ms=latency_ms, outcome="ok",
                                 under_swap=self._swapping, version=self._version)

    # ------------------------------------------------------------ hot swap

    def swap(self, score_fn: Callable, *, version: Any = None,
             digest: Any = None,
             program_cache_size: Callable[[], int] | None = None) -> float:
        """Flip to a new scorer without dropping accepted traffic: pending
        requests drain on the OLD scorer (tagged ``under_swap``), then the
        function reference flips.  Returns the swap latency in ms (also a
        ``serve_swap`` event)."""
        t0 = self._clock()
        drained = self._pending_rows
        self._swapping = True
        try:
            self.drain()
        finally:
            self._swapping = False
        self._score = score_fn
        # the old scorer's program-count probe is stale the moment we flip
        self._cache_size = program_cache_size
        old_version, self._version = self._version, version
        self._digest = digest
        swap_ms = (self._clock() - t0) * 1000.0
        self.swaps.append({"version": version, "from_version": old_version,
                           "drained_rows": drained, "swap_ms": swap_ms})
        _trace.emit("frontend", "swap", replica=self.replica,
                    version=version, digest=digest,
                    from_version=old_version, drained_rows=drained,
                    swap_ms=round(swap_ms, 3))
        if self._request_log is not None:
            # replay skips non-request events; the swap marks which
            # traffic each version served
            self._request_log.append({
                "event": "serve_swap", "version": version,
                "from_version": old_version})
        if self._logger is not None:
            self._logger.log(event="serve_swap", version=version,
                             from_version=old_version, drained_rows=drained,
                             swap_ms=swap_ms)
        return swap_ms

    # -------------------------------------------------------------- stats

    def run(self, requests) -> dict[Any, np.ndarray | None]:
        """Replay ``(request_id, batch)`` pairs through submit + poll, then
        drain."""
        for rid, batch in requests:
            self.submit(rid, batch)
            self.poll()
        self.drain()
        return self.results

    def stats(self) -> dict[str, float]:
        lat = np.asarray(self.latencies_ms, np.float64)
        out = {
            "requests": int(lat.size),
            "batches": len(self.shipped),
            "p50_ms": float(np.percentile(lat, 50)) if lat.size else 0.0,
            "p99_ms": float(np.percentile(lat, 99)) if lat.size else 0.0,
            "shed": len(self.shed),
            "swaps": len(self.swaps),
        }
        if self._under_swap_ms:
            out["p99_under_swap_ms"] = float(
                np.percentile(np.asarray(self._under_swap_ms, np.float64), 99))
        if self._logger is not None and lat.size:
            self._logger.log(event="serve_summary", **out)
        return out


def restore_and_export(config, *, log_dir=None, device="cuda"):
    """The serving entry points' start: build the trainer (it refuses knobs
    the port lacks and arms ``[faults]``), restore the newest checkpoint (a
    fresh init without one) and export the serving bundle to
    ``<log_dir or checkpoint_dir>/serving_bundle`` (under a mesh rank 0
    writes the gathered single-device state, behind a barrier).  Returns
    ``(trainer, step, bundle dir, categorical columns, continuous
    columns)``."""
    import torch.distributed as dist

    from tdfo_tpu_torch.core.config import serving_model_kind
    from tdfo_tpu_torch.interop import flax_params_from_module
    from tdfo_tpu_torch.serve.export import export_bundle
    from tdfo_tpu_torch.train.trainer import Trainer, _ctr_columns

    trainer = Trainer(config, log_dir=log_dir, device=device)
    step, state = trainer.restore_latest()
    out_dir = Path(log_dir or config.checkpoint_dir or ".") / "serving_bundle"
    sd = trainer.single_device_state()  # None off rank 0 under a mesh
    if sd is None:
        kwargs: dict[str, Any] = {}
    elif hasattr(state, "tables"):  # DMP/sparse regime
        kwargs = dict(coll=trainer.coll, tables=sd["tables"],
                      dense_params=flax_params_from_module(state.backbone,
                                                           sd["backbone"]))
    else:
        kwargs = dict(params=flax_params_from_module(state.model, sd["params"]))
    if serving_model_kind(config) == "seq":
        cat_cols: tuple[str, ...] = ()
        cont_cols: tuple[str, ...] = ()
        kwargs["seq"] = {"max_len": config.max_len, "n_heads": config.n_heads,
                         "n_layers": config.n_layers}
    else:
        cat_cols, cont_cols = _ctr_columns(config)
    if trainer.rank == 0:
        export_bundle(out_dir, model=config.model, embed_dim=config.embed_dim,
                      cat_columns=cat_cols, cont_columns=cont_cols,
                      size_map=config.size_map, step=step,
                      mixed_precision=config.mixed_precision,
                      platform=trainer.device.type, **kwargs)
    if trainer.mesh is not None:
        dist.barrier()  # the bundle is written
    return trainer, step, out_dir, cat_cols, cont_cols


def serve_from_config(config, *, log_dir: str | Path | None = None,
                      n_requests: int = 64, device="cuda") -> dict[str, Any]:
    """The ``python -m tdfo_tpu_torch.launch serve`` body: restore the
    newest checkpoint (a fresh init when there is none), export the serving
    bundle, build the scorer on ``device``, run a synthetic ragged request
    trace through the micro-batcher, then build a corpus and run one
    retrieval round (TwoTower: the item tower's corpus queried by the user
    tower; Bert4Rec: the output head queried by ``[h, 1]``).  The seq family
    ships ragged histories folded into eval windows
    (:func:`~tdfo_tpu_torch.serve.seq_scoring.history_window`) with a
    1 + 100 candidate panel.  With ``[serving] replicas > 1`` the trace is
    served round-robin by an in-process fleet of that many replicas
    following a bundle store (``<log_dir>/bundle_store``) into which the
    bundle is ingested.  Returns the stats dict."""
    import torch.distributed as dist

    from tdfo_tpu_torch.core.config import serving_model_kind
    from tdfo_tpu_torch.serve.export import load_bundle
    from tdfo_tpu_torch.serve.scoring import make_scorer

    kind = serving_model_kind(config)  # refuses unknown models
    trainer, step, out_dir, cat_cols, cont_cols = restore_and_export(
        config, log_dir=log_dir, device=device)
    mesh = trainer.mesh
    bundle = load_bundle(out_dir)
    scorer = make_scorer(bundle, mesh=mesh, device=trainer.device)

    rng = np.random.default_rng(config.seed)
    spec = config.serving
    base = Path(log_dir or config.checkpoint_dir or ".")
    fleet_mode = spec.replicas > 1
    # under a mesh only rank 0 writes (the store, the request logs)
    writer = trainer.rank == 0
    request_log = None
    if spec.log_features and not fleet_mode and writer:
        from tdfo_tpu_torch.data.replay import RequestLog

        request_log = RequestLog(base / "request_log",
                                 segment_bytes=spec.log_segment_bytes)
    buckets = ((spec.history_buckets or spec.buckets) if kind == "seq"
               else spec.buckets)
    hi = min(spec.max_batch, buckets[0])
    requests = []
    if kind == "seq":
        from tdfo_tpu_torch.serve.seq_scoring import history_window

        n_items, max_len = scorer.n_items, scorer.max_len
        for i in range(n_requests):
            n = int(rng.integers(1, hi + 1))
            seqs = np.stack([
                history_window(
                    rng.integers(1, n_items + 1,
                                 size=int(rng.integers(1, 2 * max_len))),
                    n_items=n_items, max_len=max_len,
                    max_history=spec.max_history)
                for _ in range(n)])
            cands = rng.integers(1, n_items + 1, size=(n, 101), dtype=np.int32)
            requests.append((f"req{i}", {"seqs": seqs, "cands": cands}))
    else:
        vocab = _column_vocab(config, cat_cols)
        # labels from their own rng: logging features never perturbs the
        # request trace
        label_rng = np.random.default_rng(config.seed + 1)
        for i in range(n_requests):
            n = int(rng.integers(1, hi + 1))
            batch: dict[str, np.ndarray] = {
                c: rng.integers(0, vocab[c], size=n, dtype=np.int32)
                for c in cat_cols}
            for c in cont_cols:
                batch[c] = rng.random(n, dtype=np.float32)
            if spec.log_features:
                batch["label"] = label_rng.integers(0, 2, size=n, dtype=np.int8)
            requests.append((f"req{i}", batch))

    if fleet_mode:
        from tdfo_tpu_torch.serve.fleet import ServingFleet
        from tdfo_tpu_torch.serve.swap import BundleStore

        store = BundleStore(base / "bundle_store")
        if writer and store.recover() is None:
            store.ingest_full(out_dir)
        if mesh is not None:
            dist.barrier()  # the store holds the bundle
        flt = ServingFleet(
            store, config, mesh=mesh, logger=trainer.logger,
            request_log_root=(base / "request_log"
                              if spec.log_features and writer else None),
            device=trainer.device)
        flt.sync()
        t0 = _trace.clock()
        flt.run(requests)
        wall = _trace.elapsed_s(t0)
        reps = [r for r in flt.alive() if r.batcher is not None]
        lat = np.asarray([ms for r in reps for ms in r.batcher.latencies_ms],
                         np.float64)
        stats: dict[str, Any] = {
            "requests": int(lat.size),
            "batches": sum(len(r.batcher.shipped) for r in reps),
            "p50_ms": float(np.percentile(lat, 50)) if lat.size else 0.0,
            "p99_ms": float(np.percentile(lat, 99)) if lat.size else 0.0,
            "shed": sum(len(r.batcher.shed) for r in reps),
            "swaps": sum(len(r.batcher.swaps) for r in reps),
            "replicas": len(reps),
            "version": store.current_version(),
        }
        if spec.log_features and writer:
            stats["request_log"] = str(base / "request_log")
        flt.close()
    else:
        watchdog = None
        if config.telemetry.stall_timeout_s > 0 and writer:
            from tdfo_tpu_torch.obs.watchdog import StallWatchdog

            watchdog = StallWatchdog(
                base / "heartbeat_serve.jsonl",
                config.telemetry.stall_timeout_s, label="serve",
                rotate_bytes=config.telemetry.log_rotate_bytes).start()
        t0 = _trace.clock()
        mb = MicroBatcher(
            scorer.score, buckets=buckets, max_batch=spec.max_batch,
            batch_deadline_ms=spec.batch_deadline_ms, logger=trainer.logger,
            program_cache_size=scorer.score_cache_size,
            max_queue=spec.max_queue, shed_policy=spec.shed_policy,
            watchdog=watchdog, request_log=request_log)
        mb.run(requests)
        wall = _trace.elapsed_s(t0)
        if watchdog is not None:
            watchdog.stop()
        stats = mb.stats()
        if request_log is not None:
            request_log.close()
            stats["request_log"] = str(request_log.root)
        stats["programs"] = scorer.score_cache_size()
    stats["qps"] = stats["requests"] / wall if wall > 0 else float("inf")
    stats["bundle"] = str(out_dir)
    stats["step"] = int(step)

    corpus_dtype = spec.coarse_dtype if spec.coarse_k > 0 else "float32"
    if config.model == "twotower":
        from tdfo_tpu_torch.serve.corpus import build_corpus, synthetic_item_features
        from tdfo_tpu_torch.serve.retrieval import make_retrieval

        n_items = int(config.size_map.get("item", 0))
        if n_items > spec.top_k:
            corpus = build_corpus(
                scorer, synthetic_item_features(config.size_map, n_items,
                                                seed=config.seed),
                corpus_batch=spec.corpus_batch, mesh=mesh, dtype=corpus_dtype)
            retrieve = make_retrieval(corpus, mesh=mesh, top_k=spec.top_k,
                                      coarse_k=spec.coarse_k)
            q_batch = {"user_id": np.arange(8, dtype=np.int32) %
                       max(vocab.get("user_id", 1), 1)}
            _, ids = retrieve(scorer.user_embed(q_batch))
            stats["retrieved"] = int(ids.shape[1])
    elif kind == "seq":
        from tdfo_tpu_torch.serve.retrieval import make_retrieval
        from tdfo_tpu_torch.serve.seq_scoring import history_window, item_corpus

        if scorer.n_items > spec.top_k:
            corpus = item_corpus(bundle, mesh=mesh, device=trainer.device,
                                 dtype=corpus_dtype)
            retrieve = make_retrieval(corpus, mesh=mesh, top_k=spec.top_k,
                                      coarse_k=spec.coarse_k)
            q = np.stack([
                history_window(
                    rng.integers(1, scorer.n_items + 1, size=scorer.max_len),
                    n_items=scorer.n_items, max_len=scorer.max_len)
                for _ in range(8)])
            _, ids = retrieve(scorer.query_embed({"seqs": q}))
            stats["retrieved"] = int(ids.shape[1])
    trainer.logger.close()
    return stats


def _column_vocab(config, cat_cols) -> dict[str, int]:
    """Vocab size per categorical INPUT column (size_map keys by feature for
    the TwoTower schema, by column for custom schemas)."""
    if config.categorical_features:
        return {c: int(config.size_map[c]) for c in cat_cols}
    from tdfo_tpu_torch.models.twotower import FEATURE_TO_INPUT, TWOTOWER_CATEGORICAL

    return {FEATURE_TO_INPUT[f]: int(config.size_map[f]) for f in TWOTOWER_CATEGORICAL}
