"""Step-indexed checkpoint / resume in torch format — port of
``tdfo_tpu/train/checkpoint.py``.

One directory per step id under the manager's directory, holding
``state.pt``: ``torch.save`` of ``{"layout_version": int, "state": tree}``
where the tree holds only tensors, ints and nested dicts / lists / tuples,
so it loads with ``torch.load(weights_only=True)``.  A save writes into a
hidden temporary directory and fsyncs the file and the directory; then the
data-stream cursor and the compatibility stamps, JSON sidecars beside the
step directories (``cursor_<id>.json``, ``stamps_<id>.json``, the
reference's names and keys), are written durably; last, the rename to the
step id commits the step.  A save cut off half-way is never a step, a
committed step always has its sidecars, and the newest COMPLETE checkpoint
stays the one resume reads.  Sidecars are pruned with their step
(``max_to_keep``), and so are those of a step whose commit never came.

A train state is checkpointed through its tensor-dict form
(``state.state_dict()`` / ``state.load_state_dict(tree)``, the same form the
non-finite guard's snapshots use); a plain tree of tensors is checkpointed
as it is.  Restore holds the saved tree to ``state_like``'s: a missing or
extra key, or a shape or dtype mismatch, refuses naming the key, and every
tensor lands on the template's device (the card stays the card).

A checkpoint written by the JAX package (orbax) is not readable here; the
cross-package bridge is ``interop.py``.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

import torch

from tdfo_tpu_torch.utils.retry import retry_call

__all__ = ["CheckpointManager", "LAYOUT_VERSION"]

# Storage-layout schema version, stamped into every checkpoint and verified
# on restore; the reference's history (1: original layouts; 2: fused-QKV
# feature order (head, qkv, dh); 3: fat-line embedding storage).  A mismatch
# or an unstamped payload refuses to restore: a layout change restores
# without shape errors but scrambles values.
LAYOUT_VERSION = 3

_PAYLOAD = "state.pt"


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_durable(path: Path, data: bytes) -> None:
    """Write ``data`` to ``path`` through a temporary file, fsync, rename."""
    tmp = path.with_name(f".{path.name}.tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path.parent)


def _restore_like(like: Any, saved: Any, path: str = "") -> Any:
    """``saved`` rebuilt in ``like``'s structure: tensors checked against the
    template's shape and dtype and moved to its device, ints kept."""
    where = path or "<root>"
    if isinstance(like, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"checkpoint key {where!r}: expected a dict")
        missing = [k for k in like if k not in saved]
        extra = [k for k in saved if k not in like]
        if missing or extra:
            raise ValueError(
                f"checkpoint does not match this run's state at {where!r}: "
                f"missing keys {[f'{path}{k}' for k in missing]}, unexpected "
                f"keys {[f'{path}{k}' for k in extra]}")
        return {k: _restore_like(v, saved[k], f"{path}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(like):
            raise ValueError(
                f"checkpoint key {where!r}: expected a sequence of {len(like)}")
        return type(like)(_restore_like(a, b, f"{path}{i}/")
                          for i, (a, b) in enumerate(zip(like, saved)))
    key = path.rstrip("/") or "<root>"
    if isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"checkpoint key {key!r} is not a tensor")
        if saved.shape != like.shape or saved.dtype != like.dtype:
            raise ValueError(
                f"checkpoint key {key!r} holds {saved.dtype} "
                f"{tuple(saved.shape)}, this run expects {like.dtype} "
                f"{tuple(like.shape)}")
        return saved.to(like.device)
    if type(saved) is not type(like):
        raise ValueError(
            f"checkpoint key {key!r} holds {type(saved).__name__}, this run "
            f"expects {type(like).__name__}")
    return saved


class CheckpointManager:
    """``save(step_id, state, cursor=...)`` / ``restore(state_like)`` ->
    ``(step_id, state, cursor)`` or ``None``.  ``step_id`` is the caller's
    monotone id (the Trainer's run-global data step, so mid-epoch and
    epoch-end checkpoints share one ordered namespace)."""

    def __init__(self, directory: str | Path, *, max_to_keep: int = 3):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        for stale in self._dir.glob(".tmp_*"):  # saves cut off by a kill
            shutil.rmtree(stale, ignore_errors=True)

    # ---------------------------------------------------------------- paths

    def _step_dir(self, step_id: int) -> Path:
        return self._dir / str(int(step_id))

    def _cursor_path(self, step_id: int) -> Path:
        return self._dir / f"cursor_{step_id}.json"

    def _stamps_path(self, step_id: int) -> Path:
        return self._dir / f"stamps_{step_id}.json"

    def all_steps(self) -> list[int]:
        """Step ids with a complete payload, ascending."""
        return sorted(int(p.name) for p in self._dir.iterdir()
                      if p.is_dir() and p.name.isdigit()
                      and (p / _PAYLOAD).is_file())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ----------------------------------------------------------------- save

    def save(self, step_id: int, state: Any, *,
             cursor: dict[str, Any] | None = None,
             stamps: dict[str, Any] | None = None,
             force: bool = False) -> None:
        """Write ``state`` (an object with ``state_dict()`` or a tree of
        tensors) and its ``cursor`` and ``stamps`` sidecars, commit the step
        ``step_id``, then prune to ``max_to_keep``.  ``force`` replaces an
        existing step (a crashed run's save at the same id).  I/O retries
        with backoff (``utils/retry.py``)."""
        step_id = int(step_id)
        final = self._step_dir(step_id)
        if final.exists() and not force:
            raise ValueError(f"checkpoint step {step_id} already exists in "
                             f"{self._dir} (pass force=True to replace it)")
        tree = state.state_dict() if hasattr(state, "state_dict") else state
        payload = {"layout_version": LAYOUT_VERSION, "state": tree}
        tmp = retry_call(self._write_payload, step_id, payload,
                         description=f"ckpt_save:{step_id}")
        for path, obj in ((self._cursor_path(step_id), cursor),
                          (self._stamps_path(step_id), stamps or None)):
            if obj is not None:
                retry_call(_write_durable, path, json.dumps(obj).encode(),
                           description=f"sidecar_save:{path.name}")
            elif path.exists():
                path.unlink()  # a replaced step must not keep a stale sidecar
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # the commit
        _fsync_dir(self._dir)
        self._prune()

    def _write_payload(self, step_id: int, payload: dict) -> Path:
        """The payload, durable in a hidden temporary directory."""
        tmp = self._dir / f".tmp_{step_id}_{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        with open(tmp / _PAYLOAD, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        return tmp

    def _prune(self) -> None:
        """Drop the oldest steps past ``max_to_keep`` with their sidecars,
        and sidecars whose step is gone."""
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep] if self.max_to_keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        live = set(self.all_steps())
        for p in (*self._dir.glob("cursor_*.json"), *self._dir.glob("stamps_*.json")):
            try:
                step = int(p.stem.split("_", 1)[1])
            except ValueError:
                continue
            if step not in live:
                p.unlink(missing_ok=True)

    # -------------------------------------------------------------- restore

    def read_cursor(self, step_id: int) -> dict[str, Any] | None:
        """The data-stream cursor saved with ``step_id``, or None (legacy
        epoch-indexed checkpoints have none)."""
        cpath = self._cursor_path(step_id)
        if not cpath.exists():
            return None
        return json.loads(cpath.read_text())

    def restore(self, state_like: Any, step_id: int | None = None, *,
                stamps: dict[str, Any] | None = None):
        """Restore the newest (or ``step_id``'s) checkpoint into
        ``state_like``'s structure, devices and dtypes.  A state object is
        loaded in place and returned; a plain tree comes back as a new tree.
        Returns ``(step_id, state, cursor)``, or ``None`` when there is no
        checkpoint.  Refuses a stamps mismatch, an unstamped or foreign
        layout version, and a tree that does not match the template."""
        step_id = self.latest_step() if step_id is None else int(step_id)
        if step_id is None:
            return None
        spath = self._stamps_path(step_id)
        saved_stamps = json.loads(spath.read_text()) if spath.exists() else {}
        if (stamps or {}) != saved_stamps:
            raise ValueError(
                f"checkpoint step {step_id} in {self._dir} was saved with "
                f"compatibility stamps {saved_stamps!r}, but this run "
                f"expects {(stamps or {})!r}.  The state trees may restore "
                "cleanly anyway (identical shapes) with values paired to "
                "the WRONG ids or dtypes — e.g. a bf16-stored table resumed "
                "into an f32 run — so resuming is refused.  Re-run with the "
                "matching configuration, or retrain.")
        path = self._step_dir(step_id) / _PAYLOAD
        try:
            payload = retry_call(torch.load, path, map_location="cpu",
                                 weights_only=True,
                                 description=f"ckpt_restore:{step_id}")
        except (RuntimeError, ValueError, EOFError) as e:
            raise ValueError(
                f"checkpoint step {step_id} in {self._dir} does not load as "
                f"a torch checkpoint of plain tensors ({e}); it is not a "
                "tdfo_tpu_torch checkpoint (a JAX/orbax checkpoint converts "
                "through tdfo_tpu_torch/interop.py)") from e
        if not isinstance(payload, dict) or "layout_version" not in payload:
            raise ValueError(
                f"checkpoint step {step_id} in {self._dir} does not carry a "
                "layout_version stamp (it predates the versioned format).  "
                "Parameter LAYOUT changes (fused-QKV reorder, fat-line "
                "packing) restore without shape errors but scramble values, "
                "so resuming it is refused.  Retrain, or convert the "
                "checkpoint offline.")
        found = int(payload["layout_version"])
        if found != LAYOUT_VERSION:
            raise ValueError(
                f"checkpoint step {step_id} in {self._dir} was written with "
                f"storage-layout version {found}, but this build uses "
                f"{LAYOUT_VERSION}.  The layouts are not value-compatible "
                "(see tdfo_tpu_torch/train/checkpoint.py LAYOUT_VERSION); "
                "resuming would silently scramble parameters, so it is "
                "refused.  Retrain, or convert the checkpoint offline.")
        if hasattr(state_like, "state_dict"):
            tree = _restore_like(state_like.state_dict(), payload["state"])
            state_like.load_state_dict(tree)
            state = state_like
        else:
            state = _restore_like(state_like, payload["state"])
        return step_id, state, self.read_cursor(step_id)

    def close(self) -> None:
        """Nothing stays open between calls; kept for the reference's API."""
