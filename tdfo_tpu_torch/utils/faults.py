"""The ``[faults]`` config table — port of ``tdfo_tpu/utils/faults.py``.

Only :class:`FaultSpec` is ported so far: ``core/config.py`` parses and
validates the table exactly as the reference does, so one TOML drives both
packages.  The injector that acts on it (kills, NaN batches, I/O failures,
serving and replay triggers) has not been ported; the port's trainer refuses
a config that arms any trigger (``FaultSpec.any()``) instead of ignoring it.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["FaultSpec"]


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
        for name in self.__dataclass_fields__:
            if getattr(self, name) < 0:
                raise ValueError(f"faults.{name} must be >= 0 (0 = disabled)")

    def any(self) -> bool:
        return any(getattr(self, name) for name in self.__dataclass_fields__)
