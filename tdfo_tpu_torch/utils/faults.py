"""Deterministic fault injection — port of ``tdfo_tpu/utils/faults.py``
(the whole module: ``FaultSpec``, ``FaultInjector``, ``configure``,
``active``; the same triggers, counts and one-shot markers).

``FaultSpec`` is the ``[faults]`` config table (``core/config.py`` parses
it as the reference does).  ``configure(spec, workdir)`` installs the
process-global injector that the fault sites consult through
``active()``; zero disables a trigger, and a process with none armed pays
one ``is None`` check per site.  Where each trigger acts in the port:

* serving: ``slow_score_ms`` (``serve/frontend.py::MicroBatcher`` sleeps
  per shipped batch; ``slow_canary_at_cycle`` claims it for one digest),
  ``corrupt_delta_nth`` and ``kill_during_swap`` (``serve/swap.py``: a
  payload bit-flipped in memory, a hard exit between stage and publish,
  one-shot per workdir), ``kill_replica_nth`` (``serve/fleet.py``: an
  in-process soft kill) and ``kill_replica_signal`` (``serve/supervisor.py``:
  a real ``SIGKILL`` to the replica's pid);
* the request log (``data/replay.py::RequestLog``):
  ``truncate_log_at_byte``, ``dup_record_nth``, ``corrupt_record_nth``;
* ``fail_io_nth``: the Nth call protected by ``utils/retry.retry_call``;
* training (``train/trainer.py``): ``nan_at_step`` poisons the host batch
  of that run-global step, ``stall_at_step`` / ``stall_seconds`` sleep and
  ``kill_at_step`` exits after that step's checkpoint save;
* the online loop (``train/online.py``, ``data/replay.py``):
  ``kill_during_replay``, ``kill_between_stages``, ``corrupt_candidate``,
  ``regress_auc_at_cycle``, ``kill_during_canary`` and
  ``slow_canary_at_cycle``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = ["FaultSpec", "FaultInjector", "configure", "active", "KILL_EXIT_CODE"]

KILL_EXIT_CODE = 17  # distinguishes an injected kill from real crashes
_MARKER = "faults_kill.marker"
_SWAP_MARKER = "faults_swap_kill.marker"
_REPLAY_MARKER = "faults_replay_kill.marker"
_STAGE_MARKER = "faults_stage_kill.marker"
_CANARY_MARKER = "faults_canary_kill.marker"


@dataclass(frozen=True)
class FaultSpec:
    """The ``[faults]`` config section.  All steps are 1-based run-global
    data steps; serving triggers are 1-based operation counts; 0 disables."""

    kill_at_step: int = 0
    nan_at_step: int = 0
    fail_io_nth: int = 0
    stall_at_step: int = 0
    stall_seconds: float = 0.0
    corrupt_delta_nth: int = 0
    slow_score_ms: float = 0.0
    kill_during_swap: int = 0
    truncate_log_at_byte: int = 0
    dup_record_nth: int = 0
    corrupt_record_nth: int = 0
    kill_during_replay: int = 0
    kill_between_stages: int = 0
    corrupt_candidate: int = 0
    regress_auc_at_cycle: int = 0
    kill_during_canary: int = 0
    kill_replica_nth: int = 0
    kill_replica_signal: int = 0
    slow_canary_at_cycle: int = 0

    def __post_init__(self) -> None:
        for name in ("kill_at_step", "nan_at_step", "fail_io_nth",
                     "stall_at_step", "stall_seconds", "corrupt_delta_nth",
                     "slow_score_ms", "kill_during_swap",
                     "truncate_log_at_byte", "dup_record_nth",
                     "corrupt_record_nth", "kill_during_replay",
                     "kill_between_stages", "corrupt_candidate",
                     "regress_auc_at_cycle", "kill_during_canary",
                     "kill_replica_nth", "kill_replica_signal",
                     "slow_canary_at_cycle"):
            if getattr(self, name) < 0:
                raise ValueError(f"faults.{name} must be >= 0 (0 = disabled)")

    def any(self) -> bool:
        return bool(self.kill_at_step or self.nan_at_step
                    or self.fail_io_nth or self.stall_at_step
                    or self.corrupt_delta_nth or self.slow_score_ms
                    or self.kill_during_swap or self.truncate_log_at_byte
                    or self.dup_record_nth or self.corrupt_record_nth
                    or self.kill_during_replay or self.kill_between_stages
                    or self.corrupt_candidate or self.regress_auc_at_cycle
                    or self.kill_during_canary or self.kill_replica_nth
                    or self.kill_replica_signal
                    or self.slow_canary_at_cycle)


class FaultInjector:
    """Stateful trigger evaluation for one training process."""

    def __init__(self, spec: FaultSpec, workdir: str | Path | None = None):
        self.spec = spec
        self.workdir = Path(workdir) if workdir else None
        self._io_count = 0
        self._io_fired = False
        self._stall_fired = False
        self._delta_count = 0
        self._delta_fired = False
        self._swap_count = 0
        self._truncate_fired = False
        self._dup_count = 0
        self._dup_fired = False
        self._rec_corrupt_count = 0
        self._rec_corrupt_fired = False
        self._stage_count = 0
        self._candidate_count = 0
        self._candidate_fired = False
        self._canary_count = 0
        self._replica_kill_fired = False
        self._replica_sigkill_fired = False

    # ------------------------------------------------------------- kill

    def kill_due(self, global_step: int) -> bool:
        """True when the injected preemption should fire at this step.
        Consults (and honours) the one-shot marker; does NOT exit."""
        if not self.spec.kill_at_step or global_step < self.spec.kill_at_step:
            return False
        if self.workdir is not None and (self.workdir / _MARKER).exists():
            return False  # already preempted once in this checkpoint lineage
        return True

    def maybe_kill(self, global_step: int) -> None:
        """Hard-exit (``os._exit``, no cleanup — a real preemption gives no
        cleanup either) when the kill trigger is due."""
        if not self.kill_due(global_step):
            return
        if self.workdir is not None:
            self.workdir.mkdir(parents=True, exist_ok=True)
            (self.workdir / _MARKER).write_text(
                f"killed at global step {global_step} at {time.time()}\n"
            )
        print(f"[faults] injected kill at global step {global_step}",
              flush=True)
        os._exit(KILL_EXIT_CODE)

    # -------------------------------------------------------------- nan

    def nan_due(self, global_step: int) -> bool:
        return bool(self.spec.nan_at_step) and global_step == self.spec.nan_at_step

    def poison_batch(self, batch: dict[str, np.ndarray],
                     global_step: int) -> dict[str, np.ndarray]:
        """Overwrite the first float-typed column with NaN (host-side, before
        device transfer) so the REAL step computes a non-finite loss — the
        corrupted-shard / overflow failure mode, injected deterministically."""
        if not self.nan_due(global_step):
            return batch
        for k, v in batch.items():
            if np.issubdtype(np.asarray(v).dtype, np.floating):
                out = dict(batch)
                out[k] = np.full_like(v, np.nan)
                print(f"[faults] injected NaN into column {k!r} at global "
                      f"step {global_step}", flush=True)
                return out
        raise ValueError(
            "faults.nan_at_step needs a float-typed batch column to poison; "
            "this workload ships integer-only batches"
        )

    # ------------------------------------------------------------- stall

    def maybe_stall(self, global_step: int) -> None:
        """Sleep ``stall_seconds`` once when the stall trigger is due — a
        deterministic stand-in for a hung shard read or wedged collective.
        Purely host-side: device state and the data cursor are untouched."""
        if (not self.spec.stall_at_step or self._stall_fired
                or global_step < self.spec.stall_at_step):
            return
        self._stall_fired = True
        print(f"[faults] injected {self.spec.stall_seconds:.1f}s stall at "
              f"global step {global_step}", flush=True)
        time.sleep(self.spec.stall_seconds)

    # ----------------------------------------------------------- serving

    def corrupt_delta_due(self) -> bool:
        """Called by the swap store once per delta payload it reads.  True
        exactly once, on the configured Nth read — the caller then bit-flips
        the in-memory payload so digest verification sees REAL corruption."""
        if not self.spec.corrupt_delta_nth or self._delta_fired:
            return False
        self._delta_count += 1
        if self._delta_count == self.spec.corrupt_delta_nth:
            self._delta_fired = True
            print(f"[faults] corrupting delta read #{self._delta_count}",
                  flush=True)
            return True
        return False

    def maybe_slow_score(self) -> None:
        """Sleep ``slow_score_ms`` on every shipped scoring batch — a
        deterministic wedged-scorer stand-in for the serving heartbeat.
        When ``slow_canary_at_cycle`` is ALSO set the knob is claimed by
        the digest-keyed canary slowdown (:meth:`slow_score_sleep` via the
        fleet's slow-scorer wrap) and this fleet-wide path stays fast —
        the latency regression must be differential or the p99 verdict
        term has nothing to compare."""
        if self.spec.slow_score_ms and not self.spec.slow_canary_at_cycle:
            time.sleep(self.spec.slow_score_ms / 1000.0)

    def slow_score_sleep(self) -> None:
        """Unconditional ``slow_score_ms`` sleep — called only from the
        fleet's digest-keyed slow-scorer wrap (``slow_canary_at_cycle``),
        which already decided THIS scorer is the slow one."""
        if self.spec.slow_score_ms:
            time.sleep(self.spec.slow_score_ms / 1000.0)

    def swap_kill_due(self) -> bool:
        """True when the mid-swap kill should fire on THIS apply (counts
        applies; honours the one-shot marker); does NOT exit."""
        if not self.spec.kill_during_swap:
            return False
        if self.workdir is not None and (self.workdir / _SWAP_MARKER).exists():
            return False
        self._swap_count += 1
        return self._swap_count == self.spec.kill_during_swap

    def maybe_kill_swap(self) -> None:
        """Hard-exit mid-apply (staged, not yet published) when due — the
        restart must recover to the last fully-verified version."""
        if not self.swap_kill_due():
            return
        if self.workdir is not None:
            self.workdir.mkdir(parents=True, exist_ok=True)
            (self.workdir / _SWAP_MARKER).write_text(
                f"killed during swap apply #{self._swap_count} at {time.time()}\n"
            )
        print(f"[faults] injected kill during swap apply #{self._swap_count}",
              flush=True)
        os._exit(KILL_EXIT_CODE)

    # ------------------------------------------------------------ replay

    def truncate_log_due(self, segment_bytes: int) -> bool:
        """Called by the request-log writer after each flushed append with
        the active segment's current size.  True exactly once, the first
        time the size reaches ``truncate_log_at_byte`` — the caller then
        truncates the file back to that byte, tearing the tail record."""
        if (not self.spec.truncate_log_at_byte or self._truncate_fired
                or segment_bytes < self.spec.truncate_log_at_byte):
            return False
        self._truncate_fired = True
        print(f"[faults] truncating request log at byte "
              f"{self.spec.truncate_log_at_byte}", flush=True)
        return True

    def dup_record_due(self) -> bool:
        """Called by the request-log writer once per appended record.  True
        exactly once, on the configured Nth append — the caller then writes
        the same line (same seq) a second time."""
        if not self.spec.dup_record_nth or self._dup_fired:
            return False
        self._dup_count += 1
        if self._dup_count == self.spec.dup_record_nth:
            self._dup_fired = True
            print(f"[faults] duplicating request record #{self._dup_count}",
                  flush=True)
            return True
        return False

    def corrupt_record_due(self) -> bool:
        """Called by the request-log writer once per appended record.  True
        exactly once, on the configured Nth append — the caller then flips
        payload bytes so the reader sees real garbage on a sealed line."""
        if not self.spec.corrupt_record_nth or self._rec_corrupt_fired:
            return False
        self._rec_corrupt_count += 1
        if self._rec_corrupt_count == self.spec.corrupt_record_nth:
            self._rec_corrupt_fired = True
            print(f"[faults] corrupting request record "
                  f"#{self._rec_corrupt_count}", flush=True)
            return True
        return False

    def replay_kill_due(self, n_committed: int) -> bool:
        """True when the replay-commit kill should fire (``n_committed``
        good records committed so far); honours the one-shot marker."""
        if (not self.spec.kill_during_replay
                or n_committed < self.spec.kill_during_replay):
            return False
        if self.workdir is not None and (self.workdir / _REPLAY_MARKER).exists():
            return False
        return True

    def maybe_kill_replay(self, n_committed: int) -> None:
        """Hard-exit when the replay consumer commits its Nth good record —
        the restart must resume from the persisted cursor with no dup/loss."""
        if not self.replay_kill_due(n_committed):
            return
        if self.workdir is not None:
            self.workdir.mkdir(parents=True, exist_ok=True)
            (self.workdir / _REPLAY_MARKER).write_text(
                f"killed at replay record {n_committed} at {time.time()}\n"
            )
        print(f"[faults] injected kill at replay record {n_committed}",
              flush=True)
        os._exit(KILL_EXIT_CODE)

    def maybe_kill_stage(self, stage: str) -> None:
        """Hard-exit at the Nth online-supervisor stage boundary crossed
        (one-shot per workdir) — the named stage has NOT run yet, so the
        restart must redo it idempotently from the persisted cursors."""
        if not self.spec.kill_between_stages:
            return
        if self.workdir is not None and (self.workdir / _STAGE_MARKER).exists():
            return
        self._stage_count += 1
        if self._stage_count != self.spec.kill_between_stages:
            return
        if self.workdir is not None:
            self.workdir.mkdir(parents=True, exist_ok=True)
            (self.workdir / _STAGE_MARKER).write_text(
                f"killed before stage {stage!r} (boundary "
                f"#{self._stage_count}) at {time.time()}\n"
            )
        print(f"[faults] injected kill before stage {stage!r} (boundary "
              f"#{self._stage_count})", flush=True)
        os._exit(KILL_EXIT_CODE)

    # ------------------------------------------------------------- canary

    def corrupt_candidate_due(self) -> bool:
        """Called by the gated supervisor once per exported candidate delta.
        True exactly once, on the configured Nth export — the caller then
        bit-flips the ON-DISK payload so the shadow gate's digest check and
        the re-export repair path run against real corruption."""
        if not self.spec.corrupt_candidate or self._candidate_fired:
            return False
        self._candidate_count += 1
        if self._candidate_count == self.spec.corrupt_candidate:
            self._candidate_fired = True
            print(f"[faults] corrupting candidate export "
                  f"#{self._candidate_count}", flush=True)
            return True
        return False

    def auc_regress_due(self, cycle: int) -> bool:
        """True when the candidate of gated cycle ``cycle`` should serve
        garbage (training/serving skew).  Pure compare on the DURABLE cycle
        number — no process state, so a restarted redo of the same cycle
        re-injects the identical regression."""
        return bool(self.spec.regress_auc_at_cycle
                    and cycle == self.spec.regress_auc_at_cycle)

    def slow_canary_due(self, cycle: int) -> bool:
        """True when the candidate of gated cycle ``cycle`` should score
        slowly on the replicas that load it (``slow_score_ms`` per shipped
        batch) — the latency twin of ``auc_regress_due``: same pure compare
        on the durable cycle number, same restart determinism."""
        return bool(self.spec.slow_canary_at_cycle
                    and self.spec.slow_score_ms
                    and cycle == self.spec.slow_canary_at_cycle)

    def canary_kill_due(self, rnd: int) -> bool:
        """True when the mid-canary kill should fire on THIS watch round
        (counts rounds crossed; honours the one-shot marker); does NOT
        exit."""
        if not self.spec.kill_during_canary:
            return False
        if self.workdir is not None and (self.workdir / _CANARY_MARKER).exists():
            return False
        self._canary_count += 1
        return self._canary_count == self.spec.kill_during_canary

    def maybe_kill_canary(self, rnd: int) -> None:
        """Hard-exit at the start of a canary watch round — the candidate
        reached the canary replicas but no verdict is durable, so the
        restart must redo the cycle and converge to the uninterrupted
        run's verdict."""
        if not self.canary_kill_due(rnd):
            return
        if self.workdir is not None:
            self.workdir.mkdir(parents=True, exist_ok=True)
            (self.workdir / _CANARY_MARKER).write_text(
                f"killed during canary watch round {rnd} (boundary "
                f"#{self._canary_count}) at {time.time()}\n"
            )
        print(f"[faults] injected kill during canary watch round {rnd}",
              flush=True)
        os._exit(KILL_EXIT_CODE)

    def replica_kill_due(self) -> bool:
        """Called by the fleet at the start of each canary watch round.
        True exactly once per process — the fleet then marks replica
        ``kill_replica_nth - 1`` dead (soft kill, no exit).  No marker:
        the kill re-fires on restart so every lineage sees the same
        membership."""
        if not self.spec.kill_replica_nth or self._replica_kill_fired:
            return False
        self._replica_kill_fired = True
        print(f"[faults] soft-killing replica "
              f"{self.spec.kill_replica_nth - 1} at canary watch", flush=True)
        return True

    def replica_sigkill_due(self) -> bool:
        """Called by the PROCESS fleet at the start of each canary watch
        round.  True exactly once per process — the fleet then delivers a
        real ``SIGKILL`` to child ``kill_replica_signal - 1``'s pid and the
        supervisor's respawn path takes over.  No marker, like
        :meth:`replica_kill_due`: the respawn recovers membership, so a
        restarted supervisor re-firing the kill converges anyway."""
        if not self.spec.kill_replica_signal or self._replica_sigkill_fired:
            return False
        self._replica_sigkill_fired = True
        print(f"[faults] SIGKILLing replica process "
              f"{self.spec.kill_replica_signal - 1} at canary watch",
              flush=True)
        return True

    # --------------------------------------------------------------- io

    def io_op(self, description: str) -> None:
        """Called by ``retry_call`` before each protected attempt.  Raises an
        injected ``OSError`` exactly once, on the configured Nth operation."""
        if not self.spec.fail_io_nth or self._io_fired:
            return
        self._io_count += 1
        if self._io_count == self.spec.fail_io_nth:
            self._io_fired = True
            raise OSError(
                f"[faults] injected I/O failure on op #{self._io_count} "
                f"({description})"
            )


_ACTIVE: FaultInjector | None = None


def configure(spec: FaultSpec | None,
              workdir: str | Path | None = None) -> FaultInjector | None:
    """Install the process-global injector (``None`` / empty spec clears it).
    The Trainer calls this at construction, so each run re-arms from its own
    config and stale injectors never leak across tests."""
    global _ACTIVE
    _ACTIVE = (
        FaultInjector(spec, workdir) if spec is not None and spec.any() else None
    )
    return _ACTIVE


def active() -> FaultInjector | None:
    return _ACTIVE
