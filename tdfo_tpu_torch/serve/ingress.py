"""Socket ingress: the process fleet's load balancer — port of
``tdfo_tpu/serve/ingress.py`` (host-only).

One persistent framed connection per replica (``serve/wire.py``), and each
request routed by power-of-two-choices (Mitzenmacher 2001: sample two
distinct replicas, send to the less loaded) over the ``queue_depth`` /
``batch_fill`` pair every heartbeat and score reply carries.  Every
observation is stamped at RECEIPT with this process's monotonic clock
(a sender's stamp means nothing across processes), and :meth:`Ingress.pick`
refuses replicas whose last observation is older than ``[serving]
heartbeat_stale_ms``.  A shed reply (``scores = null``) and a request lost
to a mid-flight disconnect are counted (``sheds``, ``failures``), never
silent.  Latency runs from submit to the reply's receipt: the replica
answers only after its scores are on the host.
"""

from __future__ import annotations

import random
import select
import time
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np

from tdfo_tpu_torch.obs import trace as _trace
from tdfo_tpu_torch.serve import wire

__all__ = ["Ingress"]


class Ingress:
    """Persistent connections + P2C balancing + staleness eviction.

    ``elapsed_ms``/``rng``/``sleep`` are injectable so tests pin the
    eviction window and the balance draw without wall-clock sleeps.
    """

    def __init__(self, paths: Mapping[int, str | Path], *,
                 stale_ms: float = 5000.0,
                 max_frame: int = wire.MAX_FRAME_BYTES,
                 connect_retries: int = 10,
                 connect_base_ms: float = 10.0,
                 rng: random.Random | None = None,
                 elapsed_ms: Callable[[float], float] | None = None,
                 sleep: Callable[[float], None] = time.sleep,
                 logger=None):
        self._paths = {int(k): Path(p) for k, p in paths.items()}
        self._stale_ms = float(stale_ms)
        self._max_frame = int(max_frame)
        self._connect_retries = int(connect_retries)
        self._connect_base_ms = float(connect_base_ms)
        self._rng = rng or random.Random()
        self._elapsed_ms = elapsed_ms or _trace.elapsed_ms
        self._sleep = sleep
        self._logger = logger
        self._conns: dict[int, Any] = {}
        # replica -> {"queue_depth", "batch_fill", "hb_at"}; hb_at is OUR
        # receipt stamp, not the sender's (cross-process monotonic clocks)
        self._stats: dict[int, dict[str, Any]] = {}
        self._inflight: dict[Any, tuple[int, float]] = {}  # rid -> (k, t0)
        self.completed: dict[Any, np.ndarray | None] = {}
        self.latencies_ms: list[float] = []
        self.sheds = 0
        self.failures = 0  # requests lost to a mid-flight disconnect

    # -------------------------------------------------------- connections

    def connect(self, k: int) -> None:
        """(Re)connect replica ``k``, dropping any stale connection.  A
        fresh connection counts as an observation: a replica that just
        accepted us is alive, and routable until its first eviction
        window closes."""
        self.disconnect(k)
        self._conns[k] = wire.connect(
            self._paths[k], attempts=self._connect_retries,
            base_ms=self._connect_base_ms, rng=self._rng, sleep=self._sleep)
        self.observe(k, {})

    def connect_all(self) -> None:
        for k in sorted(self._paths):
            self.connect(k)

    def disconnect(self, k: int) -> None:
        conn = self._conns.pop(k, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        self._fail_inflight(k)

    def drop(self, k: int) -> None:
        """Forget replica ``k`` entirely (quarantined by the supervisor):
        no connection, no stats, never picked again."""
        self.disconnect(k)
        self._paths.pop(k, None)
        self._stats.pop(k, None)

    def close(self) -> None:
        for k in list(self._conns):
            self.disconnect(k)

    def _fail_inflight(self, k: int) -> None:
        lost = [rid for rid, (rk, _) in self._inflight.items() if rk == k]
        for rid in lost:
            self._inflight.pop(rid)
            self.completed[rid] = None
            self.failures += 1
        if lost and self._logger is not None:
            self._logger.log(event="ingress_inflight_lost", replica=k,
                             requests=len(lost))

    # ----------------------------------------------------------- balance

    def observe(self, k: int, rec: Mapping[str, Any]) -> None:
        """Fold a health observation (heartbeat record or score reply) into
        the balance state, stamped at receipt."""
        self._stats[k] = {
            "queue_depth": int(rec.get("queue_depth", 0)),
            "batch_fill": float(rec.get("batch_fill", 0.0)),
            "hb_at": _trace.clock(),
        }

    def fresh(self) -> list[int]:
        """Connected replicas whose last observation is within the
        eviction window."""
        out = []
        for k in sorted(self._conns):
            st = self._stats.get(k)
            if st is None:
                continue
            if self._elapsed_ms(st["hb_at"]) <= self._stale_ms:
                out.append(k)
        return out

    def pick(self) -> int:
        """Power-of-two-choices over the fresh replicas: two distinct
        samples, lower ``queue_depth`` wins, ties broken by lower
        ``batch_fill`` then lower id (deterministic under an injected
        rng).  An empty fresh set is a loud error — routing a request to
        a known-stale replica would hide a dead fleet."""
        fresh = self.fresh()
        if not fresh:
            evicted = sorted(set(self._conns) - set(fresh))
            raise RuntimeError(
                "ingress has no fresh replica to route to "
                f"(stale/evicted: {evicted}, window {self._stale_ms} ms) — "
                "the fleet is dead or the supervisor has not respawned "
                "anyone yet")
        if len(fresh) == 1:
            return fresh[0]
        a, b = self._rng.sample(fresh, 2)
        ka = (self._stats[a]["queue_depth"], self._stats[a]["batch_fill"], a)
        kb = (self._stats[b]["queue_depth"], self._stats[b]["batch_fill"], b)
        return a if ka <= kb else b

    # ------------------------------------------------------------ traffic

    def submit(self, rid, feats: Mapping[str, np.ndarray]) -> int:
        """Route one score request; returns the replica it went to."""
        k = self.pick()
        try:
            wire.send_msg(self._conns[k],
                          {"type": "score", "rid": rid,
                           "feats": wire.encode_feats(feats)},
                          max_frame=self._max_frame)
        except OSError:
            self.disconnect(k)
            raise
        self._inflight[rid] = (k, _trace.clock())
        return k

    def poll(self, timeout_s: float = 0.0) -> int:
        """Drain readable replies; returns how many completed.  A
        disconnect mid-poll fails that replica's in-flight requests
        (counted, never silent) and drops the connection — the caller's
        next ``check()``/``connect()`` decides recovery."""
        done = 0
        while self._conns:
            socks = {conn: k for k, conn in self._conns.items()}
            readable, _, _ = select.select(list(socks), [], [], timeout_s)
            if not readable:
                return done
            for conn in readable:
                k = socks[conn]
                try:
                    msg = wire.recv_msg(conn, max_frame=self._max_frame)
                except wire.WireError:
                    self.disconnect(k)
                    continue
                self._complete(k, msg)
                done += 1
            timeout_s = 0.0  # only the first select waits
        return done

    def _complete(self, k: int, msg: Mapping[str, Any]) -> None:
        """Fold one score reply: latency from OUR submit stamp, balance
        observation from the replica's queue state, trace span for the
        offline assembler."""
        rid = msg.get("rid")
        self.observe(k, msg)
        if rid is None or rid not in self._inflight:
            return
        _, t0 = self._inflight.pop(rid)
        ms = self._elapsed_ms(t0)
        scores = msg.get("scores")
        if scores is None:
            self.completed[rid] = None
            self.sheds += 1
        else:
            self.completed[rid] = np.asarray(scores, np.float32)
            self.latencies_ms.append(ms)
        _trace.emit("ingress", "ingress_request", replica=k, rid=str(rid),
                    latency_ms=ms, shed=scores is None,
                    queue_depth=int(msg.get("queue_depth", 0)))

    def inflight(self) -> int:
        return len(self._inflight)

    # --------------------------------------------------------------- rpc

    def rpc(self, k: int, msg: Mapping[str, Any]) -> dict[str, Any]:
        """Synchronous round trip to replica ``k`` (sync / heartbeat /
        probe / drain).  Score replies that arrive first are folded into
        ``completed`` — the replica flushes its pending scores before
        answering a drain, and this loop preserves that ordering."""
        conn = self._conns[k]
        wire.send_msg(conn, msg, max_frame=self._max_frame)
        while True:
            reply = wire.recv_msg(conn, max_frame=self._max_frame)
            if "rid" in reply:
                self._complete(k, reply)
                continue
            return reply
