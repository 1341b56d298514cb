"""Process supervisor and out-of-process fleet — port of
``tdfo_tpu/serve/supervisor.py``.

:class:`ProcessSupervisor` spawns each replica as ``python -m
tdfo_tpu_torch.serve.replica_main <spec.json>`` through
``subprocess.Popen`` (fork then exec, so a parent that already holds a
CUDA context never forks it into a child), with the listener bound in the
supervisor and passed down by fd (socket activation: connects queue in the
kernel backlog from the instant of spawn, while the child imports torch,
opens its CUDA context and loads its bundle).  It detects deaths by
``poll()``, respawns with capped exponential backoff
(``utils/retry.backoff_delay``), and quarantines a replica that dies
``[serving] flap_max_deaths`` times within ``flap_window_s`` seconds; the
fleet then degrades to the survivors, loudly.

:class:`ProcessFleet` has the ``ServingFleet`` surface (``sync``,
``heartbeat``, ``mark_canary_watch``, ``probe_each``, ``run``,
``versions``) across real OS boundaries: ``sync`` is an RPC fan-out,
``run`` routes through the power-of-two-choices ingress, and the death
drill is a real ``SIGKILL`` (``[faults] kill_replica_signal``) whose
respawned replica re-follows ``CURRENT`` / ``CANARY`` by (version,
digest).  Each child scores on the device its spec names (``device``:
the fleet's, ``"cuda"`` by default; ``"cuda:k"`` puts replica k on card
k).  Death stamps, respawn sleeps and the backoff draw are injectable.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from tdfo_tpu_torch.obs import trace as _trace
from tdfo_tpu_torch.serve import wire
from tdfo_tpu_torch.serve.ingress import Ingress
from tdfo_tpu_torch.utils import faults as _faults
from tdfo_tpu_torch.utils.retry import backoff_delay

__all__ = ["ProcessSupervisor", "ProcessFleet"]


class ProcessSupervisor:
    """Spawn / monitor / respawn replica processes with flap quarantine.

    ``spec_paths`` maps replica id -> the spec JSON its child re-reads on
    every (re)spawn — the spec file IS the lineage identity, which is what
    makes a respawn re-follow the store instead of starting a new replica.
    """

    def __init__(self, spec_paths: Mapping[int, str | Path], *,
                 respawn_base_ms: float = 50.0,
                 respawn_max_ms: float = 2000.0,
                 flap_window_s: float = 30.0,
                 flap_max_deaths: int = 3,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 rng: random.Random | None = None,
                 popen: Callable[..., Any] | None = None,
                 logger=None):
        self._spec_paths = {int(k): Path(p) for k, p in spec_paths.items()}
        self._respawn_base_s = float(respawn_base_ms) / 1000.0
        self._respawn_max_s = float(respawn_max_ms) / 1000.0
        self._flap_window_s = float(flap_window_s)
        self._flap_max_deaths = int(flap_max_deaths)
        self._sleep = sleep
        self._clock = clock
        self._rng = rng or random.Random()
        self._popen = popen or self._spawn_child
        self._logger = logger
        self._procs: dict[int, Any] = {}
        self._death_times: dict[int, list[float]] = {k: []
                                                     for k in self._spec_paths}
        self._consecutive: dict[int, int] = {k: 0 for k in self._spec_paths}
        self.quarantined: set[int] = set()
        self.respawns: dict[int, int] = {k: 0 for k in self._spec_paths}

    @staticmethod
    def _spawn_child(spec_path: Path):
        """Spawn one replica child, socket-activation style.

        The SUPERVISOR binds the listener and passes the fd
        (``--listen-fd`` + ``pass_fds``), so the socket accepts
        connections from the instant ``Popen`` returns — the child's
        cold start (interpreter, torch import, CUDA context, bundle load)
        queues connects in the kernel backlog instead of racing the
        ingress's retry budget.  The child finds this package on
        ``PYTHONPATH`` whatever its working directory.  Child stdio goes to
        ``replica-<k>.log`` beside the spec, never an inherited pipe: an
        orphaned child holding a test harness's pipe write-end would
        wedge the harness's ``communicate()`` long after the parent
        died.
        """
        spec = json.loads(Path(spec_path).read_text())
        sock_path = spec.get("socket")
        argv = [sys.executable, "-m", "tdfo_tpu_torch.serve.replica_main",
                str(spec_path)]
        log_path = Path(spec_path).with_suffix(".log")
        env = dict(os.environ)
        pkg_root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH")) if p)
        with open(log_path, "ab") as logf:
            if sock_path is None:  # bare spec: child binds for itself
                return subprocess.Popen(
                    argv, stdin=subprocess.DEVNULL, stdout=logf,
                    stderr=logf, env=env)
            listener = wire.listen(sock_path)
            try:
                fd = listener.fileno()
                return subprocess.Popen(
                    argv + ["--listen-fd", str(fd)],
                    stdin=subprocess.DEVNULL, stdout=logf, stderr=logf,
                    pass_fds=(fd,), env=env)
            finally:
                # the child's inherited fd keeps the socket bound and
                # its backlog live; this only drops the parent's copy
                listener.close()

    # ----------------------------------------------------------- lifecycle

    def spawn(self, k: int) -> None:
        if k in self.quarantined:
            raise RuntimeError(f"replica {k} is quarantined (flap-looping); "
                               "refusing to respawn it")
        self._procs[k] = self._popen(self._spec_paths[k])

    def spawn_all(self) -> None:
        for k in sorted(self._spec_paths):
            self.spawn(k)

    def pid(self, k: int) -> int | None:
        proc = self._procs.get(k)
        return None if proc is None else proc.pid

    def alive_ids(self) -> list[int]:
        return [k for k, p in sorted(self._procs.items())
                if p is not None and p.poll() is None]

    def kill(self, k: int, sig: int = signal.SIGKILL) -> None:
        """Deliver a real signal to replica ``k``'s pid — the
        ``kill_replica_signal`` drill's hammer."""
        proc = self._procs.get(k)
        if proc is not None and proc.poll() is None:
            os.kill(proc.pid, sig)
            proc.wait()  # reap; poll() in check() then sees the death

    def quarantine(self, k: int) -> None:
        """Force-quarantine (the in-process ``kill_replica_nth`` twin for
        process fleets: the replica is terminated and never respawned, so
        membership stays degraded exactly like the soft-kill path)."""
        if k in self.quarantined:
            return
        self.kill(k)
        self._procs.pop(k, None)
        self.quarantined.add(k)
        self._note_quarantine(k, reason="forced")

    def _note_quarantine(self, k: int, *, reason: str) -> None:
        print(f"[supervisor] replica {k} QUARANTINED ({reason}); fleet "
              f"degrades to the survivors", flush=True)
        if self._logger is not None:
            self._logger.log(event="replica_quarantined", replica=k,
                             reason=reason)
        _trace.emit("supervisor", "replica_quarantined", replica=k,
                    reason=reason)

    def check(self) -> list[int]:
        """Detect deaths, respawn with backoff, quarantine flappers.
        Returns the ids respawned THIS call (the ingress must reconnect
        them)."""
        respawned: list[int] = []
        for k in sorted(self._procs):
            proc = self._procs[k]
            if proc is None or proc.poll() is None:
                continue
            code = proc.returncode
            self._procs[k] = None
            now = self._clock()
            window = [t for t in self._death_times[k]
                      if now - t <= self._flap_window_s]
            window.append(now)
            self._death_times[k] = window
            self._consecutive[k] += 1
            if self._logger is not None:
                self._logger.log(event="replica_died", replica=k,
                                 returncode=code,
                                 deaths_in_window=len(window))
            _trace.emit("supervisor", "replica_died", replica=k,
                        returncode=code, deaths_in_window=len(window))
            if len(window) >= self._flap_max_deaths:
                self._procs.pop(k, None)
                self.quarantined.add(k)
                self._note_quarantine(
                    k, reason=f"{len(window)} deaths in "
                    f"{self._flap_window_s:.0f}s window")
                continue
            delay = backoff_delay(self._consecutive[k] - 1,
                                  base_delay=self._respawn_base_s,
                                  max_delay=self._respawn_max_s,
                                  rng=self._rng)
            self._sleep(delay)
            self.spawn(k)
            self.respawns[k] += 1
            respawned.append(k)
        return respawned

    def mark_healthy(self, k: int) -> None:
        """Reset the consecutive-death backoff counter once a respawned
        replica answers an RPC (the flap WINDOW keeps counting — backoff
        resets on recovery, quarantine does not)."""
        self._consecutive[k] = 0

    def shutdown(self) -> None:
        for k, proc in list(self._procs.items()):
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        self._procs.clear()


class ProcessFleet:
    """N replica PROCESSES following one store — the ``ServingFleet``
    surface across real OS boundaries.

    The canary cohort is the same deterministic law as the in-process
    fleet (first ``max(1, int(n * canary_fraction))`` ids), persisted into
    each child's spec file so a respawned lineage keeps its cohort.
    ``heartbeat`` RPCs carry durations, not timestamps (durations compare
    across processes; timestamps do not), and every record is re-stamped
    ``hb_at`` at ingress receipt for staleness eviction.  ``device``: where
    the children score — one device for all, or one per replica (replica
    k takes ``device[k % len(device)]``: ``["cuda:0", "cuda:1", ...]``
    is one replica per card).
    """

    def __init__(self, store, config, *, workdir: str | Path,
                 logger=None, request_log_root=None,
                 device: str | Sequence[str] = "cuda"):
        n = int(config.serving.replicas)
        if n < 2:
            raise ValueError(
                f"fleet_mode='process' needs serving.replicas >= 2, got {n}")
        spec = config.serving
        self.store = store
        self.spec = spec
        self._logger = logger
        frac = float(config.online.canary_fraction)
        self.n_canary = max(1, int(n * frac))
        self.workdir = Path(workdir) / "fleet"
        self.workdir.mkdir(parents=True, exist_ok=True)

        paths: dict[int, Path] = {}
        spec_paths: dict[int, Path] = {}
        serving_dict = dataclasses.asdict(spec)
        serving_dict["buckets"] = list(serving_dict["buckets"])
        slow_ms = float(config.faults.slow_score_ms or 0.0)
        for k in range(n):
            sock = self.workdir / f"replica-{k}.sock"
            cspec = {
                "replica_id": k,
                "socket": str(sock),
                "store_dir": str(store.root),
                "serving": serving_dict,
                "canary_member": k < self.n_canary,
                "request_log_root": (None if request_log_root is None
                                     else str(request_log_root)),
                "trace_dir": (str(_trace.trace_dir())
                              if _trace.active() else None),
                "slow_score_ms": slow_ms,
                "device": (device if isinstance(device, str)
                           else str(device[k % len(device)])),
            }
            spath = self.workdir / f"replica-{k}.json"
            spath.write_text(json.dumps(cspec, indent=1))
            paths[k] = sock
            spec_paths[k] = spath

        self.supervisor = ProcessSupervisor(
            spec_paths,
            respawn_base_ms=spec.respawn_base_ms,
            respawn_max_ms=spec.respawn_max_ms,
            flap_window_s=spec.flap_window_s,
            flap_max_deaths=spec.flap_max_deaths,
            logger=logger)
        self.ingress = Ingress(
            paths, stale_ms=spec.heartbeat_stale_ms,
            max_frame=spec.max_frame_bytes,
            connect_retries=spec.connect_retries,
            connect_base_ms=spec.connect_base_ms,
            logger=logger)
        self._skew_digests: set[str] = set()
        self._slow_digests: set[str] = set()
        self._versions: dict[int, int | None] = {}
        try:
            self.supervisor.spawn_all()
            self.ingress.connect_all()
        except BaseException:
            # a half-built fleet must not leak children: an orphaned
            # replica runs forever (and on a test harness, holds pipes)
            self.supervisor.shutdown()
            raise

    # ------------------------------------------------------------ members

    @property
    def _dead(self) -> set[int]:
        """Quarantined ids — the degraded-membership set the fleet worker
        reports (name-compatible with ``ServingFleet._dead``)."""
        return set(self.supervisor.quarantined)

    def alive_ids(self) -> list[int]:
        return [k for k in self.supervisor.alive_ids()
                if k not in self.supervisor.quarantined]

    def set_score_skew(self, digest: str) -> None:
        self._skew_digests.add(str(digest))

    def set_score_slow(self, digest: str) -> None:
        self._slow_digests.add(str(digest))

    def mark_canary_watch(self) -> None:
        """Consult the replica-death faults at a canary watch round:
        ``kill_replica_signal`` delivers a real SIGKILL to the victim's
        pid (the supervisor's next ``check`` respawns it);
        ``kill_replica_nth`` quarantines the victim (the in-process
        soft-kill twin — membership stays degraded)."""
        inj = _faults.active()
        if inj is None:
            return
        if inj.replica_sigkill_due():
            victim = int(inj.spec.kill_replica_signal) - 1
            if victim in self.supervisor._spec_paths:
                self.supervisor.kill(victim, signal.SIGKILL)
                self.ingress.disconnect(victim)
                if self._logger is not None:
                    self._logger.log(event="replica_sigkilled",
                                     replica=victim,
                                     reason="kill_replica_signal")
        if inj.replica_kill_due():
            victim = int(inj.spec.kill_replica_nth) - 1
            if victim in self.supervisor._spec_paths:
                self.supervisor.quarantine(victim)
                self.ingress.drop(victim)
                if self._logger is not None:
                    self._logger.log(event="replica_dead", replica=victim,
                                     reason="kill_replica_nth")

    # -------------------------------------------------------------- sync

    def check(self) -> list[int]:
        """Respawn any dead, unquarantined replicas and reconnect their
        ingress links; quarantined ids are dropped from routing."""
        respawned = self.supervisor.check()
        for k in self.supervisor.quarantined:
            self.ingress.drop(k)
        for k in respawned:
            self.ingress.connect(k)
        return respawned

    def sync(self) -> dict[int, int | None]:
        """Fan the pointer-follow RPC to every alive replica, always with
        the FULL skew/slow digest sets (idempotent re-arm: a respawned
        child starts blank and must relearn every armed fault or its
        lineage diverges from the unkilled reference)."""
        self.check()
        msg = {"type": "sync", "skew": sorted(self._skew_digests),
               "slow": sorted(self._slow_digests)}
        self._versions = {}
        for k in self.alive_ids():
            reply = self.ingress.rpc(k, msg)
            # an answered sync is an observation: a child whose start-up
            # (torch import, CUDA context, bundle load) outlasts
            # heartbeat_stale_ms must not be evicted before its first
            # request (the reference keeps the connect-time stamp)
            self.ingress.observe(k, reply)
            self._versions[k] = reply.get("version")
            self.supervisor.mark_healthy(k)
            _trace.emit("fleet", "replica_sync_rpc", replica=k,
                        version=reply.get("version"),
                        digest=reply.get("digest"))
        return dict(self._versions)

    def versions(self) -> dict[int, int | None]:
        return dict(self._versions)

    # ---------------------------------------------------------- heartbeat

    def heartbeat(self, feats: Mapping[str, np.ndarray],
                  labels: np.ndarray) -> list[dict[str, Any]]:
        """One RPC health sample per alive replica — the same record shape
        as ``ServingFleet.heartbeat`` (the canary verdict consumes either),
        re-stamped at receipt and fed to the balancer."""
        enc = wire.encode_feats(feats)
        lab = np.asarray(labels).ravel().tolist()
        out: list[dict[str, Any]] = []
        for k in self.alive_ids():
            reply = self.ingress.rpc(
                k, {"type": "heartbeat", "feats": enc, "labels": lab})
            rec = {key: reply[key] for key in
                   ("replica", "version", "auc", "ms", "canary")}
            for key in ("queue_depth", "batch_fill"):
                if key in reply:
                    rec[key] = reply[key]
            rec["hb_at"] = _trace.clock()  # receipt stamp, OUR clock
            self.ingress.observe(k, rec)
            _trace.emit("fleet", "heartbeat", **rec)
            out.append(rec)
        return out

    # -------------------------------------------------------------- serve

    def run(self, requests) -> dict[Any, np.ndarray | None]:
        """Route a request trace through the P2C ingress, then drain every
        replica and collect.  Sheds come back as ``None`` (counted at the
        ingress), exactly like ``MicroBatcher.run``."""
        if not self.alive_ids():
            raise RuntimeError("no alive replica process to serve on")
        for rid, batch in requests:
            self.ingress.submit(rid, batch)
            self.ingress.poll(0.0)
        for k in self.alive_ids():
            self.ingress.rpc(k, {"type": "drain"})
        while self.ingress.inflight():
            if self.ingress.poll(1.0) == 0:
                break  # remaining in-flight died with a connection
        return dict(self.ingress.completed)

    def probe_each(self, requests) -> dict[int, dict[Any, np.ndarray]]:
        """The bitwise fleet-convergence probe, per replica process."""
        payload = [[rid, wire.encode_feats(batch)] for rid, batch in requests]
        # JSON object keys are strings; map replies back to the callers' rids
        rid_by_str = {str(rid): rid for rid, _ in requests}
        out: dict[int, dict[Any, np.ndarray]] = {}
        for k in self.alive_ids():
            reply = self.ingress.rpc(k, {"type": "probe",
                                         "requests": payload})
            out[k] = {rid_by_str.get(s, s): None if v is None
                      else np.asarray(v, np.float32)
                      for s, v in reply["results"].items()}
        return out

    def close(self) -> None:
        for k in self.alive_ids():
            try:
                self.ingress.rpc(k, {"type": "shutdown"})
            except (wire.WireError, OSError, KeyError):
                pass
        self.ingress.close()
        self.supervisor.shutdown()
