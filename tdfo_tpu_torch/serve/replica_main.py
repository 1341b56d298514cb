"""Replica process entry — port of ``tdfo_tpu/serve/replica_main.py``:
``python -m tdfo_tpu_torch.serve.replica_main spec.json [--listen-fd N]``.

One :class:`~tdfo_tpu_torch.serve.fleet.ReplicaFrontend` behind an
``AF_UNIX`` listener, speaking the ``serve/wire.py`` protocol.  The
supervisor (``serve/supervisor.py``) writes the spec and spawns this
module; the ingress connects and drives it.  The process is the replica:
``kill -9`` takes the scorer, the batcher and the connection down with it,
and the respawned process re-reads the same spec, re-follows ``CURRENT`` /
``CANARY`` by (version, digest) through the shared bundle store (a
follower: ``recover`` belongs to the store's one writer) and reopens the
same ``replica-<k>`` request log, whose writer resumes its seq line.

Start-up: the supervisor binds the listener before spawning and passes it
as ``--listen-fd`` (socket activation), so the ingress's connect lands in
the kernel backlog while this process imports torch, opens its CUDA
context, loads the bundle onto its device and warms up; the first RPC
blocks until then.  Run by hand (no ``--listen-fd``), the process binds
for itself and the ingress's connect retries cover the start.

Spec keys: ``replica_id``, ``socket``, ``store_dir``, ``serving`` (a
``[serving]`` dict), ``canary_member``, ``request_log_root`` (optional),
``trace_dir`` (optional; spans append to the shared sinks, one whole line
per write), ``slow_score_ms`` (the one fault a replica honours; kill
faults belong to the parent) and ``device`` (default ``"cuda"``).  The
replica scores there and nowhere else: a child that cannot reach its
device exits non-zero, it never falls back to the CPU.  A score reply is
sent after the scores are on the host.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Any


def _serve(spec: dict[str, Any], listener) -> None:
    import select

    import numpy as np
    import torch

    from tdfo_tpu_torch.core.config import ServingSpec
    from tdfo_tpu_torch.core.device import resolve_device
    from tdfo_tpu_torch.obs import trace as _trace
    from tdfo_tpu_torch.serve import wire
    from tdfo_tpu_torch.serve.fleet import ReplicaFrontend
    from tdfo_tpu_torch.serve.swap import BundleStore
    from tdfo_tpu_torch.train.metrics import binary_auc
    from tdfo_tpu_torch.utils import faults as _faults

    device = resolve_device(spec.get("device", "cuda"))
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the context, now: fail here if absent
    if spec.get("trace_dir"):
        _trace.configure(spec["trace_dir"])
    slow_ms = float(spec.get("slow_score_ms") or 0.0)
    if slow_ms:
        _faults.configure(_faults.FaultSpec(slow_score_ms=slow_ms))

    serving_raw = dict(spec["serving"])
    serving_raw["buckets"] = tuple(serving_raw["buckets"])
    serving = ServingSpec(**serving_raw)
    max_frame = serving.max_frame_bytes
    replica_id = int(spec["replica_id"])

    store = BundleStore(spec["store_dir"])  # follower: no recover()
    replica = ReplicaFrontend(
        replica_id, store, serving, mesh=None,
        request_log_root=spec.get("request_log_root"),
        canary_member=bool(spec.get("canary_member", False)), device=device)

    warmed: set[Any] = set()
    poll_s = max(serving.batch_deadline_ms / 1000.0, 0.001)

    def flush_replies(conn, pending: set) -> None:
        # every completed rid (scored or shed) answers exactly once, and
        # carries the batcher's queue state so score replies double as
        # balance observations at the ingress
        b = replica.batcher
        if b is None:
            return
        for rid in [r for r in list(b.results) if r in pending]:
            scores = b.results.pop(rid)
            pending.discard(rid)
            wire.send_msg(conn, {
                "type": "reply", "rid": rid,
                "scores": None if scores is None
                else np.asarray(scores, np.float32).ravel().tolist(),
                "queue_depth": b.last_queue_depth,
                "batch_fill": b.last_batch_fill,
            }, max_frame=max_frame)

    def handle(conn, msg: dict[str, Any], pending: set) -> bool:
        """Dispatch one message; False ends the process."""
        kind = msg.get("type")
        if kind == "score":
            replica.batcher.submit(msg["rid"], wire.decode_feats(msg["feats"]))
            pending.add(msg["rid"])
            replica.batcher.poll()
            flush_replies(conn, pending)
        elif kind == "sync":
            version = replica.sync(frozenset(msg.get("skew") or ()),
                                   frozenset(msg.get("slow") or ()))
            served = replica._served
            wire.send_msg(conn, {
                "type": "synced", "replica": replica_id, "version": version,
                "digest": None if served is None else served[1],
            }, max_frame=max_frame)
        elif kind == "heartbeat":
            feats = wire.decode_feats(msg["feats"])
            labels = np.asarray(msg["labels"])
            if replica._served not in warmed:
                # unmeasured warm-up, mirroring ServingFleet.heartbeat: the
                # first call's set-up would otherwise show up as a
                # per-cycle canary p99 regression
                warmed.add(replica._served)
                replica.score_direct({k: np.array(v)
                                      for k, v in feats.items()})
            t0 = _trace.clock()
            scores = replica.score_direct({k: np.array(v)
                                           for k, v in feats.items()})
            ms = _trace.elapsed_ms(t0)
            rec: dict[str, Any] = {
                "type": "heartbeat_reply", "replica": replica_id,
                "version": replica.version(),
                "auc": float(binary_auc(labels, scores)), "ms": ms,
                "canary": replica.canary_member,
            }
            if replica.batcher is not None:
                rec["queue_depth"] = replica.batcher.last_queue_depth
                rec["batch_fill"] = replica.batcher.last_batch_fill
            wire.send_msg(conn, rec, max_frame=max_frame)
        elif kind == "probe":
            trace = [(rid, wire.decode_feats(enc))
                     for rid, enc in msg["requests"]]
            results = replica.batcher.run(trace)
            pending.difference_update(results)
            wire.send_msg(conn, {
                "type": "probed", "replica": replica_id,
                "results": {str(rid): None if v is None
                            else np.asarray(v, np.float32).ravel().tolist()
                            for rid, v in results.items()},
            }, max_frame=max_frame)
        elif kind == "drain":
            if replica.batcher is not None:
                replica.batcher.drain()
            flush_replies(conn, pending)
            wire.send_msg(conn, {"type": "drained", "replica": replica_id},
                          max_frame=max_frame)
        elif kind == "shutdown":
            wire.send_msg(conn, {"type": "bye", "replica": replica_id},
                          max_frame=max_frame)
            return False
        else:
            raise wire.WireError(f"unknown message type {kind!r}")
        return True

    running = True
    while running:
        conn, _ = listener.accept()  # one ingress connection at a time
        pending: set = set()
        try:
            while True:
                readable, _, _ = select.select([conn], [], [], poll_s)
                if not readable:
                    # deadline tick: ship expired partial batches, answer
                    # their waiters
                    if replica.batcher is not None:
                        replica.batcher.poll()
                        flush_replies(conn, pending)
                    continue
                if not handle(conn, wire.recv_msg(conn, max_frame=max_frame),
                              pending):
                    running = False
                    break
        except wire.Disconnect:
            pass  # ingress went away; drop state, wait for a reconnect
        except wire.WireError as e:
            print(f"[replica {replica_id}] wire error: {e}", file=sys.stderr,
                  flush=True)
        finally:
            try:
                conn.close()
            except OSError:
                pass
    replica.close()


def main() -> None:
    spec = json.loads(Path(sys.argv[1]).read_text())

    from tdfo_tpu_torch.serve import wire

    if "--listen-fd" in sys.argv:
        # socket activation: adopt the supervisor's pre-bound listener —
        # its backlog has been accepting connects since before this
        # interpreter existed
        fd = int(sys.argv[sys.argv.index("--listen-fd") + 1])
        listener = wire.listener_from_fd(fd)
    else:
        # manual run: bind here — the ingress can still connect (and
        # queue its first RPC in the backlog) while the replica starts
        listener = wire.listen(spec["socket"])
    try:
        _serve(spec, listener)
    finally:
        listener.close()
        Path(spec["socket"]).unlink(missing_ok=True)


if __name__ == "__main__":
    main()
