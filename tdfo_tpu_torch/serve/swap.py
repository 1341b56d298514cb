"""Crash-safe bundle store and hot-swap orchestration — port of
``tdfo_tpu/serve/swap.py`` (host-only: the store moves numpy arrays and
files, and for the same operations leaves pointers, manifests and version
directories byte-identical to the reference's).

Layout under the store root::

    versions/v000000/   fully materialized bundles (bundle.json +
    versions/v000001/   arrays.npz), published by directory rename
    CURRENT             {"version": N, "digest": ...}, atomic JSON
    CANARY              the same shape: the staged rollout the canary
                        cohort serves while it is watched
    quarantine.json     deltas refused as corrupt
    rejections.json     (version, digest) pairs rolled back

Durability: :func:`atomic_write_json` (temp file, fsync, ``os.replace``,
fsync of the directory) for pointers and records; :func:`publish_dir`
(fsync every staged file and the directory, then one rename) for version
directories.  A crash between stage and publish leaves only a ``*.tmp``
directory, which :meth:`BundleStore.recover` deletes before pointing
``CURRENT`` at the newest version whose digest verifies.  ``CANARY`` is
written before its directory is published, and promotion advances
``CURRENT`` before clearing ``CANARY``, so a canary pointer at or below
``CURRENT`` is a completed promotion.  A delta whose payload does not hash
to its digest is quarantined and the last good version keeps serving;
after ``max_bad_deltas`` in a row the controller reports degraded mode.
The ``[faults]`` triggers ``corrupt_delta_nth`` and ``kill_during_swap``
drive both paths.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np

from tdfo_tpu_torch.obs import trace as _trace
from tdfo_tpu_torch.serve.export import (
    apply_delta_arrays,
    bundle_digest,
    read_raw_bundle,
    write_raw_bundle,
)
from tdfo_tpu_torch.utils import faults
from tdfo_tpu_torch.utils.retry import retry_call

__all__ = [
    "BundleStore",
    "CorruptDeltaError",
    "DeltaChainError",
    "DeltaPoller",
    "SwapController",
    "atomic_write_json",
    "publish_dir",
]

_CURRENT = "CURRENT"
_CANARY = "CANARY"
_QUARANTINE = "quarantine.json"
_REJECTIONS = "rejections.json"


class DeltaChainError(ValueError):
    """The delta does not extend the current chain head (gap, re-order, or
    parent digest mismatch) — a loud refusal, never applied."""


class CorruptDeltaError(ValueError):
    """The delta payload fails digest verification — quarantined, the last
    good version keeps serving."""


# ------------------------------------------------------- atomic primitives


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_json(path: str | Path, obj: Any) -> None:
    """The blessed pointer-file writer: temp in the same directory, fsync,
    ``os.replace`` (atomic on POSIX), fsync the directory so the rename
    itself is durable.  A reader sees the old complete file or the new
    complete file, never a torn one."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w") as f:
        f.write(json.dumps(obj, indent=1, sort_keys=True))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path.parent)


def publish_dir(staged: str | Path, final: str | Path) -> None:
    """The blessed directory publisher: fsync every file in the staged
    directory (its contents were written by ordinary buffered I/O), fsync
    the directory, then ONE rename to the final name.  Readers discover
    bundles by final name only, so a half-written bundle is unreachable."""
    staged, final = Path(staged), Path(final)
    for p in sorted(staged.rglob("*")):
        if p.is_file():
            fd = os.open(p, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
    _fsync_dir(staged)
    os.replace(staged, final)
    _fsync_dir(final.parent)


# --------------------------------------------------------------- the store


def _version_name(version: int) -> str:
    return f"v{version:06d}"


def _read_manifest(vdir: Path) -> dict:
    """Whole-file manifest read (NOT a line tailer — the quality suite
    confines line-oriented json.loads loops to data/replay.py)."""
    return json.loads((vdir / "bundle.json").read_text())


class BundleStore:
    """Versioned, digest-verified bundle store with an atomic CURRENT pointer.

    Every bundle directory under ``versions/`` is fully materialized (deltas
    are composed at ingest, not at serve time), so recovery never needs to
    re-walk a chain: the newest directory whose digest verifies IS the last
    fully-verified version.
    """

    def __init__(self, root: str | Path, *, keep_versions: int = 0):
        if keep_versions < 0:
            raise ValueError(
                f"keep_versions must be >= 0 (0 = keep everything), "
                f"got {keep_versions}")
        self.root = Path(root)
        self.versions = self.root / "versions"
        self.versions.mkdir(parents=True, exist_ok=True)
        # retention budget beyond the protected CURRENT/CANARY chain
        # ([serving] keep_versions); 0 disables gc_versions entirely
        self.keep_versions = int(keep_versions)

    # ------------------------------------------------------------ queries

    def _read_pointer(self, name: str) -> dict | None:
        p = self.root / name
        if not p.exists():
            return None
        rec = json.loads(p.read_text())
        return {"version": int(rec["version"]), "digest": rec["digest"]}

    def current_version(self) -> int | None:
        cur = self._read_pointer(_CURRENT)
        return None if cur is None else cur["version"]

    def current_dir(self) -> Path | None:
        v = self.current_version()
        return None if v is None else self.versions / _version_name(v)

    def canary_version(self) -> int | None:
        can = self._read_pointer(_CANARY)
        return None if can is None else can["version"]

    def canary_dir(self) -> Path | None:
        v = self.canary_version()
        return None if v is None else self.versions / _version_name(v)

    def quarantined(self) -> list[dict]:
        qpath = self.root / _QUARANTINE
        return json.loads(qpath.read_text()) if qpath.exists() else []

    def rejections(self) -> list[dict]:
        rpath = self.root / _REJECTIONS
        return json.loads(rpath.read_text()) if rpath.exists() else []

    def _rejected_keys(self) -> set[tuple[int, str]]:
        return {(int(r["version"]), r["digest"]) for r in self.rejections()}

    def _read_current(self) -> tuple[dict, dict[str, np.ndarray]]:
        cdir = self.current_dir()
        if cdir is None:
            raise ValueError(f"bundle store {self.root} has no CURRENT version")
        return retry_call(read_raw_bundle, cdir,
                          description=f"bundle read {cdir.name}")

    # ------------------------------------------------------------- writes

    def _publish(self, manifest: dict, arrays: dict[str, np.ndarray],
                 version: int, *, is_swap: bool = False) -> Path:
        final = self.versions / _version_name(version)
        if final.exists():
            raise ValueError(
                f"bundle store already holds {final.name} — versions are "
                "immutable once published")
        staged = self.versions / (_version_name(version) + ".tmp")
        if staged.exists():
            shutil.rmtree(staged)  # leftover from a crashed apply
        write_raw_bundle(staged, manifest, arrays)
        inj = faults.active()
        if is_swap and inj is not None:
            inj.maybe_kill_swap()  # the canonical half-applied crash point
        publish_dir(staged, final)
        atomic_write_json(self.root / _CURRENT,
                          {"version": version, "digest": manifest["digest"]})
        _trace.emit("swap", "pointer_flip", op="publish", pointer=_CURRENT,
                    version=version, digest=manifest["digest"])
        return final

    def ingest_full(self, bundle_dir: str | Path) -> int:
        """Verify and publish a FULL bundle (chain head / chain reset).

        Refuses a digest-corrupt bundle and a version that does not advance
        the store (re-ingesting the head is idempotent-by-refusal, not
        silent overwrite)."""
        manifest, arrays = retry_call(
            read_raw_bundle, bundle_dir,
            description=f"full bundle read {Path(bundle_dir).name}")
        got = bundle_digest(manifest, arrays)
        if got != manifest.get("digest"):
            raise ValueError(
                f"full bundle {bundle_dir}: digest {got} != manifest "
                f"{manifest.get('digest')!r} — refusing a corrupt bundle")
        if manifest.get("kind") == "delta":
            raise ValueError(
                f"{bundle_dir} is a delta, not a full bundle — deltas go "
                "through apply_delta against the current version")
        version = int(manifest.get("version", 0))
        cur = self.current_version()
        if cur is not None and version <= cur:
            raise ValueError(
                f"full bundle {bundle_dir} is v{version}, store already "
                f"serves v{cur} — stale full export refused")
        self._publish(manifest, arrays, version)
        return version

    def apply_delta(self, delta_dir: str | Path) -> int:
        """Compose a delta onto CURRENT and publish the result atomically.

        Chain violations (gap / re-order / wrong parent) raise
        :class:`DeltaChainError`; payload corruption raises
        :class:`CorruptDeltaError` (the caller quarantines).  Either way
        CURRENT is untouched until the composed bundle is fully staged,
        fsynced, published, and digest-verified.
        """
        manifest, arrays = self.compose_delta(delta_dir)
        self._publish(manifest, arrays, int(manifest["version"]), is_swap=True)
        return int(manifest["version"])

    def compose_delta(self, delta_dir: str | Path
                      ) -> tuple[dict, dict[str, np.ndarray]]:
        """Verify a delta end-to-end (own digest, chain position, base
        bytes) and compose it onto CURRENT **in memory** — nothing is
        published.  The gated supervisor scores this composition on the
        shadow slice before any pointer moves; :meth:`apply_delta` and
        :meth:`publish_canary` both build on it."""
        delta_dir = Path(delta_dir)
        dmanifest, darrays = retry_call(
            read_raw_bundle, delta_dir,
            description=f"delta read {delta_dir.name}")
        inj = faults.active()
        if inj is not None and inj.corrupt_delta_due():
            # bit-flip the payload IN MEMORY so digest verification runs
            # against real corruption, not a mocked exception
            if darrays:
                k = sorted(darrays)[0]
                a = np.array(darrays[k])
                a.view(np.uint8).reshape(-1)[0] ^= 0xFF
                darrays = dict(darrays, **{k: a})
            else:
                dmanifest = dict(dmanifest, digest="0" * 16)
        if dmanifest.get("kind") != "delta":
            raise DeltaChainError(
                f"{delta_dir} is not a delta (kind={dmanifest.get('kind')!r})")
        own = bundle_digest(dmanifest, darrays)
        if own != dmanifest.get("digest"):
            raise CorruptDeltaError(
                f"delta {delta_dir.name}: payload hashes to {own}, manifest "
                f"says {dmanifest.get('digest')!r} — corrupt delta")
        base_manifest, base_arrays = self._read_current()
        # verify the served base's ACTUAL bytes, not just its manifest field:
        # a delta that happens to rewrite the torn rows would otherwise
        # launder parent corruption into a result whose digest verifies
        base_got = bundle_digest(base_manifest, base_arrays)
        if base_got != base_manifest.get("digest"):
            raise CorruptDeltaError(
                f"serving base v{base_manifest.get('version')}: payload "
                f"hashes to {base_got}, manifest says "
                f"{base_manifest.get('digest')!r} — corrupt base, refusing "
                "to compose")
        try:
            manifest, arrays = apply_delta_arrays(
                base_manifest, base_arrays, dmanifest, darrays)
        except ValueError as e:
            msg = str(e)
            if "out of order" in msg or "parent digest" in msg:
                raise DeltaChainError(msg) from e
            raise CorruptDeltaError(msg) from e
        return manifest, arrays

    # ------------------------------------------------------------- canary

    def publish_canary(self, delta_dir: str | Path,
                       composed: tuple[dict, dict[str, np.ndarray]] | None
                       = None) -> int:
        """Publish a gated candidate under the ``CANARY`` pointer; CURRENT
        is untouched.  ``composed`` reuses the (manifest, arrays) the
        shadow gate already verified via :meth:`compose_delta`.

        Pointer-first ordering + deterministic re-export make this
        redoable: a restarted supervisor recomposes identical bytes, finds
        the pointer naming the same digest and either adopts the already-
        published directory or re-stages it — a kill at ANY byte of a
        canary publish converges on retry."""
        manifest, arrays = (composed if composed is not None
                            else self.compose_delta(delta_dir))
        version = int(manifest["version"])
        final = self.versions / _version_name(version)
        atomic_write_json(self.root / _CANARY,
                          {"version": version, "digest": manifest["digest"]})
        _trace.emit("swap", "pointer_flip", op="canary", pointer=_CANARY,
                    version=version, digest=manifest["digest"])
        if final.exists():
            try:
                m, a = read_raw_bundle(final)
                if (bundle_digest(m, a) == m.get("digest")
                        == manifest["digest"]):
                    return version  # redo after a kill: already published
            except Exception:
                pass
            shutil.rmtree(final)  # torn or stale bytes at this version
        staged = self.versions / (_version_name(version) + ".tmp")
        if staged.exists():
            shutil.rmtree(staged)
        write_raw_bundle(staged, manifest, arrays)
        inj = faults.active()
        if inj is not None:
            inj.maybe_kill_swap()  # same half-applied crash point as CURRENT
        publish_dir(staged, final)
        return version

    def promote_canary(self) -> int | None:
        """Advance ``CURRENT`` to the watched canary version (digest-
        re-verified from disk) and clear the ``CANARY`` pointer.
        Idempotent: with no pending canary — or one at/below CURRENT, the
        crashed-between-pointer-writes window — it just clears and returns
        the serving head."""
        can = self._read_pointer(_CANARY)
        cur = self.current_version()
        if can is None:
            return cur
        if cur is not None and can["version"] <= cur:
            (self.root / _CANARY).unlink(missing_ok=True)
            return cur
        vdir = self.versions / _version_name(can["version"])
        manifest, arrays = retry_call(
            read_raw_bundle, vdir, description=f"canary read {vdir.name}")
        got = bundle_digest(manifest, arrays)
        if got != can["digest"]:
            raise ValueError(
                f"canary {vdir.name}: payload hashes to {got}, pointer says "
                f"{can['digest']!r} — refusing to promote corrupt bytes")
        atomic_write_json(self.root / _CURRENT,
                          {"version": can["version"], "digest": can["digest"]})
        (self.root / _CANARY).unlink(missing_ok=True)
        _trace.emit("swap", "pointer_flip", op="promote", pointer=_CURRENT,
                    version=can["version"], digest=can["digest"])
        self.gc_versions()
        return can["version"]

    def rollback_canary(self, reason: str) -> int | None:
        """Reject the pending canary: record its ``(version, digest)`` in
        ``rejections.json`` (durable FIRST — recover() then prunes the
        directory even if this process dies mid-rollback), delete its
        directory so the version number is reusable by the next candidate,
        clear ``CANARY``, and digest-verify that CURRENT still serves the
        last good bytes — the bitwise rollback guarantee.  Idempotent:
        with no pending canary only the CURRENT verification runs."""
        can = self._read_pointer(_CANARY)
        if can is not None:
            self._record_rejection(can["version"], can["digest"], reason)
            vdir = self.versions / _version_name(can["version"])
            if vdir.exists():
                shutil.rmtree(vdir)
            (self.root / _CANARY).unlink(missing_ok=True)
            _trace.emit("swap", "pointer_flip", op="rollback",
                        pointer=_CANARY, version=can["version"],
                        digest=can["digest"], reason=reason)
        cdir = self.current_dir()
        if cdir is not None:
            manifest, arrays = self._read_current()
            got = bundle_digest(manifest, arrays)
            if got != manifest.get("digest"):
                raise ValueError(
                    f"rollback target v{manifest.get('version')}: payload "
                    f"hashes to {got}, manifest says "
                    f"{manifest.get('digest')!r} — the last good version is "
                    "itself corrupt")
        return self.current_version()

    def _record_rejection(self, version: int, digest: str,
                          reason: str) -> None:
        rec = {"version": int(version), "digest": digest,
               "reason": reason, "time": time.time()}
        existing = self.rejections()
        if any(r["version"] == rec["version"] and r["digest"] == rec["digest"]
               for r in existing):
            return  # redo of a crashed rollback: already recorded
        atomic_write_json(self.root / _REJECTIONS, existing + [rec])

    # ---------------------------------------------------------- retention

    def gc_versions(self) -> list[int]:
        """Retention sweep ([serving] keep_versions): beyond the protected
        CURRENT/CANARY chain, keep only the ``keep_versions`` newest
        published directories.  CURRENT's bytes are digest-verified BEFORE
        anything is deleted — a sweep never removes fallback history while
        the serving head is corrupt.  Returns the pruned versions."""
        if not self.keep_versions:
            return []
        protect = {v for v in (self.current_version(), self.canary_version())
                   if v is not None}
        try:
            manifest, arrays = self._read_current()
            if bundle_digest(manifest, arrays) != manifest.get("digest"):
                return []  # corrupt head: recover(), don't prune history
        except Exception:
            return []
        listed: list[tuple[int, Path]] = []
        for vdir in self.versions.iterdir():
            if vdir.is_dir() and not vdir.name.endswith(".tmp"):
                try:
                    listed.append((int(vdir.name.lstrip("v")), vdir))
                except ValueError:
                    continue
        listed.sort(reverse=True)
        pruned: list[int] = []
        survivors = 0
        for version, vdir in listed:
            if version in protect:
                continue
            if survivors < self.keep_versions:
                survivors += 1
                continue
            shutil.rmtree(vdir)
            pruned.append(version)
        return pruned

    # ----------------------------------------------------------- recovery

    def recover(self) -> int | None:
        """Restart-after-crash entry point: delete stray ``*.tmp`` staging
        directories and gatekeeper-rejected version directories, validate
        the ``CANARY`` pointer (cleared when it names rejected, missing,
        corrupt, or already-promoted bytes), then walk published versions
        newest-first — EXCLUDING a surviving canary, which is staged but
        unvetted — and point CURRENT at the first one whose content digest
        verifies (pruning any newer corrupt/torn directory).  Ends with the
        retention sweep.  Returns the recovered version, or ``None`` for an
        empty store."""
        for stray in self.versions.glob("*.tmp"):
            shutil.rmtree(stray)
        rejected = self._rejected_keys()
        if rejected:
            # a crash between rejection record and directory delete leaves
            # the rolled-back bytes on disk; finish the delete here so the
            # walk below can never re-adopt them
            for vdir in list(self.versions.iterdir()):
                if not vdir.is_dir():
                    continue
                try:
                    manifest = _read_manifest(vdir)
                    key = (int(manifest["version"]), manifest.get("digest"))
                except Exception:
                    continue  # torn directory: the walk below prunes it
                if key in rejected:
                    shutil.rmtree(vdir)
        canary_v: int | None = None
        can = self._read_pointer(_CANARY)
        cur_ptr = self._read_pointer(_CURRENT)
        if (can is not None and cur_ptr is not None
                and can["version"] <= cur_ptr["version"]):
            # promotion advanced CURRENT but crashed before clearing the
            # canary pointer: the candidate IS the vetted head now, so the
            # pointer is a completed promotion's leftover, not a pending one
            (self.root / _CANARY).unlink(missing_ok=True)
            can = None
        if can is not None:
            cdir = self.versions / _version_name(can["version"])
            ok = False
            if (can["version"], can["digest"]) not in rejected and cdir.exists():
                try:
                    manifest, arrays = read_raw_bundle(cdir)
                    ok = (bundle_digest(manifest, arrays)
                          == manifest.get("digest") == can["digest"])
                except Exception:
                    ok = False
                if not ok and cdir.exists():
                    shutil.rmtree(cdir)
            if ok:
                canary_v = can["version"]
            else:
                # pointer-before-directory crash window (or a rejected /
                # corrupt candidate): the supervisor's redo republishes
                (self.root / _CANARY).unlink(missing_ok=True)
        best: tuple[int, dict] | None = None
        for vdir in sorted(self.versions.iterdir(), reverse=True):
            if not vdir.is_dir():
                continue
            if canary_v is not None and vdir.name == _version_name(canary_v):
                continue  # staged but unvetted: never the serving head
            try:
                manifest, arrays = read_raw_bundle(vdir)
                if bundle_digest(manifest, arrays) != manifest.get("digest"):
                    raise ValueError("digest mismatch")
                if (int(manifest["version"]),
                        manifest.get("digest")) in rejected:
                    raise ValueError("gatekeeper-rejected bytes")
                best = (int(manifest["version"]), manifest)
                break
            except Exception:
                # torn/corrupt directory: unreachable once CURRENT skips it
                shutil.rmtree(vdir)
        if best is None:
            cur = self.root / _CURRENT
            if cur.exists():
                cur.unlink()
            if canary_v is not None:
                # a canary with no base to fall back on is unservable
                (self.root / _CANARY).unlink(missing_ok=True)
                shutil.rmtree(self.versions / _version_name(canary_v),
                              ignore_errors=True)
            return None
        version, manifest = best
        if canary_v is not None and canary_v <= version:
            # promotion completed before the crash cleared the pointer
            (self.root / _CANARY).unlink(missing_ok=True)
        atomic_write_json(self.root / _CURRENT,
                          {"version": version, "digest": manifest["digest"]})
        _trace.emit("swap", "pointer_flip", op="recover", pointer=_CURRENT,
                    version=version, digest=manifest["digest"])
        self.gc_versions()
        return version

    def record_quarantine(self, delta_dir: str | Path, error: str) -> None:
        rec = {"path": str(delta_dir), "error": error, "time": time.time()}
        atomic_write_json(self.root / _QUARANTINE, self.quarantined() + [rec])


# ------------------------------------------------------------ orchestration


class DeltaPoller:
    """Cadence gate + chain-directory discovery for the serving loop.

    The exporter drops chain entries next to each other
    (``<chain_root>/v000001`` …); the poller checks for the successor of the
    store's current version at most once per ``poll_s`` (the ``[serving]
    swap_poll_s`` knob), injectable clock for tests.

    Clock robustness: ``poll_s <= 0`` degenerates to "always due" (poll
    every tick) instead of arming a gate that floating-point drift could
    wedge, and a BACKWARDS clock jump (NTP step, VM migration — the
    injectable clock is not guaranteed monotonic) re-arms the deadline
    relative to the new ``now`` rather than stalling until the old epoch is
    reached again."""

    def __init__(self, chain_root: str | Path, *, poll_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.chain_root = Path(chain_root)
        self.poll_s = float(poll_s)
        self._clock = clock
        self._next = self._clock()  # first poll is due immediately

    def due(self) -> bool:
        if self.poll_s <= 0:
            return True  # no cadence gate: every tick polls
        now = self._clock()
        if now < self._next - self.poll_s:
            # the clock jumped backwards: the stored deadline is unreachable
            # garbage from the old epoch.  Re-arm one full interval out so
            # the cadence contract (at most one poll per poll_s) holds in
            # the new epoch instead of stalling for the jump's magnitude.
            self._next = now + self.poll_s
            return False
        if now < self._next:
            return False
        self._next = now + self.poll_s
        return True

    def next_delta(self, current_version: int) -> Path | None:
        cand = self.chain_root / _version_name(current_version + 1)
        return cand if (cand / "bundle.json").exists() else None


class SwapController:
    """Drives the store + MicroBatcher through verified hot-swaps, absorbing
    corrupt deltas into quarantine and surfacing degraded mode.

    ``build_score_fn(bundle_dir) -> score_fn`` rebuilds the scorer from a
    published bundle directory (typically ``make_scorer(load_bundle(d,
    verify=True))``); the controller never lets a failed rebuild take down
    the frontend — the old scorer keeps serving.
    """

    def __init__(self, store: BundleStore,
                 build_score_fn: Callable[[Path], Callable],
                 batcher=None, *, max_bad_deltas: int = 3,
                 logger=None, watchdog=None):
        if max_bad_deltas < 1:
            raise ValueError(f"max_bad_deltas must be >= 1, got {max_bad_deltas}")
        self.store = store
        self.build_score_fn = build_score_fn
        self.batcher = batcher
        self.max_bad_deltas = int(max_bad_deltas)
        self.logger = logger
        self.watchdog = watchdog
        self.consecutive_bad = 0
        self.degraded = False

    def _log(self, **rec) -> None:
        if self.logger is not None:
            self.logger.log(**rec)

    def _set_degraded(self, flag: bool) -> None:
        if flag != self.degraded:
            self.degraded = flag
            self._log(event="serving_degraded", degraded=flag,
                      bad_deltas=self.consecutive_bad)
        if self.watchdog is not None:
            self.watchdog.set_status(degraded=self.degraded,
                                     bad_deltas=self.consecutive_bad)

    def apply(self, delta_dir: str | Path) -> bool:
        """Apply one delta end to end: verify + compose + publish + rebuild
        scorer + drain-and-flip the batcher.  Returns True on a completed
        swap; False when the delta was quarantined (still serving the last
        good version).  Chain violations raise — a gap or re-order is an
        exporter-side bug the frontend must not paper over."""
        try:
            version = self.store.apply_delta(delta_dir)
        except CorruptDeltaError as e:
            self.store.record_quarantine(delta_dir, str(e))
            self.consecutive_bad += 1
            self._log(event="delta_quarantined", path=str(delta_dir),
                      error=str(e), consecutive_bad=self.consecutive_bad)
            self._set_degraded(self.consecutive_bad >= self.max_bad_deltas)
            return False
        score_fn = retry_call(
            self.build_score_fn, self.store.current_dir(),
            description=f"scorer rebuild v{version}")
        if self.batcher is not None:
            self.batcher.swap(score_fn, version=version)
        self.consecutive_bad = 0
        self._set_degraded(False)
        return True

    def poll(self, poller: DeltaPoller) -> bool:
        """One serving-loop tick: when the poller is due and the chain has a
        successor delta, apply it.  Returns True when a swap completed."""
        if not poller.due():
            return False
        cur = self.store.current_version()
        if cur is None:
            return False
        nxt = poller.next_delta(cur)
        if nxt is None:
            return False
        if any(q["path"] == str(nxt) for q in self.store.quarantined()):
            # a quarantined PATH is re-tried only when the bytes on disk
            # have verifiably changed since the refusal (the exporter
            # re-wrote a good delta at the same chain position) — that is
            # how a degraded frontend recovers without an operator poke,
            # while still-corrupt bytes are never re-applied in a loop
            try:
                m, a = read_raw_bundle(nxt)
                if (m.get("kind") != "delta"
                        or bundle_digest(m, a) != m.get("digest")):
                    return False
            except Exception:
                return False
        return self.apply(nxt)
