"""Streaming data loading: parquet shards -> shuffled, host-sharded, device-fed
batches.

Port of ``tdfo_tpu/data/loader.py``:

  * :class:`ParquetStream` — record-batch streaming with a block shuffle
    buffer (each row emitted exactly once per epoch; mixing radius =
    ``buffer_size``), per-host sharding (files round-robin when there are
    enough files, else strided batch slices), epoch reseeding, ``drop_last``
    for static shapes, optional threaded file read-ahead and corrupted-shard
    quarantine.  The reference's code with the jax process queries replaced
    by ``torch.distributed`` rank / world size (0 / 1 without a process
    group), so the same seed yields the same numpy batch sequence in both
    packages.
  * :class:`MapStream` — map-style full-permutation epochs over an
    in-memory table (``streaming = false``), with the same cursor.
  * :func:`prefetch_to_device` — ``prefetch_to_mesh``'s counterpart: a
    pinned-memory, ``non_blocking=True`` host-to-device double buffer.

The cursor is ``(seed, epoch, batches_emitted)``: an epoch's batch sequence
is a pure function of ``(seed, epoch)``, so a resumed stream fast-forwards
over the batches already consumed and yields the uninterrupted epoch's tail.
Not ported yet: ``TFRecordStream`` (``ROADMAP.md`` Queue A item 16b).
Fixed-width list columns are stacked into [B, T] arrays.
"""

from __future__ import annotations

import glob as _glob
import zlib
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

import torch

from tdfo_tpu_torch.utils.retry import retry_call

# failure modes a corrupted/truncated shard presents as: quarantinable when
# the stream was configured with max_bad_shards > 0
_BAD_SHARD_ERRORS = (OSError, EOFError, zlib.error, pa.ArrowException)

__all__ = ["ParquetStream", "MapStream", "load_parquet_table",
           "prefetch_to_device", "resolve_files"]


def _process_index_count() -> tuple[int, int]:
    """(rank, world size) of the initialised ``torch.distributed`` group, or
    (0, 1) for a single-process run (the jax.process_index/process_count
    counterpart)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _to_numpy_columns(batch: pa.RecordBatch | pa.Table,
                      allow_ragged: bool = False) -> dict[str, np.ndarray]:
    """Arrow -> dict of numpy; fixed-width list columns become [B, T] arrays.
    With ``allow_ragged`` every list column becomes an object array of
    per-row arrays (always, so a batch whose rows happen to share one length
    keeps the representation the shuffle pool concatenates); without it a
    ragged column fails here with an actionable message."""
    out: dict[str, np.ndarray] = {}
    for name, col in zip(batch.schema.names, batch.columns):
        if pa.types.is_list(col.type) or pa.types.is_large_list(col.type):
            arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
            flat = arr.flatten().to_numpy(zero_copy_only=False)
            offsets = arr.offsets.to_numpy(zero_copy_only=False)
            widths = np.diff(offsets)
            if allow_ragged:
                # flatten() is slice-aware but .offsets is absolute: rebase
                rel = offsets - offsets[0]
                obj = np.empty(len(arr), dtype=object)
                for i, r in enumerate(np.split(flat, rel[1:-1])):
                    obj[i] = r
                out[name] = obj
                continue
            if len(widths) and (widths != widths[0]).any():
                raise ValueError(
                    f"list column {name!r} is ragged; these shards were "
                    "written for the jagged path (config jagged = true) "
                    "— or pad them in preprocessing")
            t = int(widths[0]) if len(widths) else 0
            out[name] = flat.reshape(len(arr), t)
        else:
            out[name] = col.to_numpy(zero_copy_only=False)
    return out


def _concat_rows(parts: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _take(d: dict[str, np.ndarray], idx) -> dict[str, np.ndarray]:
    return {k: v[idx] for k, v in d.items()}


def resolve_files(data_dir: str | Path, pattern: str) -> list[str]:
    files = sorted(_glob.glob(str(Path(data_dir) / pattern)))
    if not files:
        raise FileNotFoundError(f"no parquet files match {pattern!r} in {data_dir}")
    return files


class ParquetStream:
    """Streaming shuffled batches from parquet shards.

    Each epoch yields every (host-local) row exactly once, in an order
    randomised by (seed, epoch): file order is permuted, then rows pass
    through a ``buffer_size``-row block shuffle.  With ``drop_last`` the
    ragged tail batch is dropped (train); otherwise it is emitted short
    (eval, to be padded by the caller).
    """

    def __init__(
        self,
        files: Sequence[str],
        batch_size: int,
        *,
        shuffle: bool = True,
        buffer_size: int = 2_000_000,  # jax-flax/train_dp.py:129 default
        seed: int = 42,
        drop_last: bool = True,
        process_index: int | None = None,
        process_count: int | None = None,
        columns: Sequence[str] | None = None,
        num_workers: int = 0,
        max_bad_shards: int = 0,
        allow_ragged: bool = False,
    ):
        self.files = list(files)
        self.allow_ragged = allow_ragged
        # corrupted-shard quarantine: files that failed to open/decode are
        # skipped (0 rows) with a warning; the (max_bad_shards+1)-th bad
        # shard is fatal.  0 keeps the historical any-failure-is-fatal
        # behaviour.
        self.max_bad_shards = int(max_bad_shards)
        self._bad_files: dict[str, str] = {}
        # >0: that many background threads read files ahead of the consumer
        # (order-preserving, so shuffles stay deterministic) — the
        # capability the reference gets from tf.data num_parallel_reads /
        # DataLoader num_workers; pyarrow/zlib release the GIL, so plain
        # threads pipeline decode behind device compute.
        self.num_workers = int(num_workers)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.buffer_size = int(buffer_size)
        self.seed = seed
        self.drop_last = drop_last
        self.columns = list(columns) if columns is not None else None
        self._epoch = 0
        self._skip = 0  # resume fast-forward pending for the next __iter__
        self._emitted = 0
        rank, world = _process_index_count()
        self.process_index = rank if process_index is None else process_index
        self.process_count = world if process_count is None else process_count
        # split_dataset_by_node parity (torchrec/data.py:58): whole files per
        # host when they divide evenly, else strided row-block sharding.
        self._shard_by_file = (
            self.process_count > 1 and len(self.files) % self.process_count == 0
        )

    # ---- file reads ----

    def _file_row_count(self, path: str) -> int:
        return retry_call(
            lambda: pq.ParquetFile(path).metadata.num_rows,
            description=f"parquet_metadata:{Path(path).name}",
        )

    def _file_batches(self, path: str):
        pf = retry_call(pq.ParquetFile, path,
                        description=f"open_shard:{Path(path).name}")
        for rb in pf.iter_batches(batch_size=65536, columns=self.columns):
            yield _to_numpy_columns(rb, self.allow_ragged)

    # ---- corrupted-shard quarantine ----

    def _quarantine(self, path: str, err: BaseException) -> None:
        """Record ``path`` as bad (skip + warn).  Raises once MORE than
        ``max_bad_shards`` distinct shards have failed — a data set that
        rotten is a pipeline bug, not a shard to shrug off."""
        if path not in self._bad_files:
            self._bad_files[path] = f"{type(err).__name__}: {err}"
            print(f"[loader] quarantined bad shard {path}: "
                  f"{self._bad_files[path]} "
                  f"({len(self._bad_files)}/{self.max_bad_shards} allowed)",
                  flush=True)
        if len(self._bad_files) > self.max_bad_shards:
            raise RuntimeError(
                f"{len(self._bad_files)} corrupted shard(s), more than "
                f"max_bad_shards={self.max_bad_shards} allows: "
                f"{self._bad_files}"
            ) from err

    def _row_count_safe(self, path: str) -> int:
        """Row count with quarantine: a shard whose footer/sidecar cannot be
        read counts 0 rows and is excluded from iteration — deterministic
        across hosts because EVERY host scans every footer for the budget."""
        if path in self._bad_files:
            return 0
        try:
            return self._file_row_count(path)
        except _BAD_SHARD_ERRORS as e:
            self._quarantine(path, e)
            return 0

    def _files_batches(self, files: Sequence[str]):
        """All batches across ``files`` in order; with ``num_workers`` > 0 a
        background thread per in-flight file decodes into a small BOUNDED
        queue (never a whole materialised file), up to ``num_workers`` files
        ahead of the consumer.  Order is preserved — determinism is part of
        the loader's contract — and host memory stays O(num_workers x a few
        arrow batches)."""
        files = [f for f in files if f not in self._bad_files]
        if self.num_workers <= 0:
            for f in files:
                try:
                    yield from self._file_batches(f)
                except _BAD_SHARD_ERRORS as e:
                    # mid-read corruption: rows already emitted from this
                    # shard stay emitted; the remainder is quarantined.  On
                    # multi-host meshes this can shrink one host's row count
                    # below the footer-derived budget — shared-storage
                    # corruption is visible to every host, but keep
                    # max_bad_shards=0 on pods unless shards replicate.
                    self._quarantine(f, e)
            return
        import collections
        import queue as _queue
        import threading

        _END = object()
        # set when the consumer abandons the generator (exception mid-epoch,
        # generator GC): workers must notice and exit instead of blocking on
        # a full queue forever, pinning open readers and decoded batches
        stop = threading.Event()

        def start_reader(path: str):
            q: _queue.Queue = _queue.Queue(maxsize=2)

            def put(item) -> bool:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        return True
                    except _queue.Full:
                        continue
                return False

            def worker():
                try:
                    for d in self._file_batches(path):
                        if not put(d):
                            return
                    put(_END)
                except BaseException as e:  # surfaced on the consumer side
                    put(e)

            t = threading.Thread(target=worker, daemon=True)
            t.start()
            return q

        pending: collections.deque = collections.deque()
        it = iter(files)
        try:
            for _ in range(self.num_workers):
                f = next(it, None)
                if f is None:
                    break
                pending.append((f, start_reader(f)))
            while pending:
                path, q = pending.popleft()
                while True:
                    item = q.get()
                    if item is _END:
                        break
                    if isinstance(item, BaseException):
                        if isinstance(item, _BAD_SHARD_ERRORS):
                            self._quarantine(path, item)  # skip the rest
                            break
                        raise item
                    yield item
                f = next(it, None)
                if f is not None:
                    pending.append((f, start_reader(f)))
        finally:
            stop.set()
            for _, q in pending:  # unblock any waiting worker
                while not q.empty():
                    try:
                        q.get_nowait()
                    except _queue.Empty:
                        break

    def _batches_per_host(self) -> int | None:
        """Cross-host batch budget from parquet metadata (no communication).

        Hosts MUST run the same number of batches per epoch or the first
        collective after the shortest host's last batch deadlocks the mesh
        (SURVEY.md §7 hard part #4).  Row counts come from file footers, so
        every host computes the same minimum independently."""
        if self.process_count <= 1:
            return None
        if self._shard_by_file:
            rows = [
                sum(
                    self._row_count_safe(f)
                    for f in self.files[r :: self.process_count]
                )
                for r in range(self.process_count)
            ]
            min_rows = min(rows)
        else:
            # strided: rank r owns global rows g with g % P == r_assigned;
            # the smallest share is floor(N / P).
            n = sum(self._row_count_safe(f) for f in self.files)
            min_rows = n // self.process_count
        return min_rows // self.batch_size

    def max_batches_per_host(self) -> int:
        """The LARGEST per-host batch count this epoch (ceil division, no
        drop_last): the eval loop's budget.  Every host runs this many
        steps, topping up with zero-weight template batches, so the ranks'
        collectives stay in lockstep (reference ``max_batches_per_host``)."""
        counts = []
        p = max(self.process_count, 1)
        for r in range(p):
            if self._shard_by_file:
                rows = sum(self._row_count_safe(f) for f in self.files[r::p])
            else:
                n = sum(self._row_count_safe(f) for f in self.files)
                rows = (n - r + p - 1) // p
            counts.append(-(-rows // self.batch_size))
        return max(counts)

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle order for a new epoch; clears a pending resume
        fast-forward (call :meth:`load_state_dict` after it)."""
        self._epoch = int(epoch)
        self._skip = 0

    def state_dict(self) -> dict[str, int]:
        """The cursor ``(seed, epoch, batches emitted this epoch)``; it pins
        the exact batch.  It counts batches handed to the caller of
        ``__iter__``: behind a prefetcher, count consumed batches yourself
        (the Trainer does)."""
        return {"seed": int(self.seed), "epoch": int(self._epoch),
                "batches_emitted": int(self._emitted)}

    def load_state_dict(self, state: dict[str, int]) -> None:
        """Resume: the next ``__iter__`` decodes and discards
        ``batches_emitted`` batches (the shuffle pool must replay to
        reproduce the stream bit for bit) and yields from there."""
        _check_cursor_seed(state, self.seed)
        self._epoch = int(state["epoch"])
        self._skip = int(state["batches_emitted"])

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        budget = self._batches_per_host() if self.drop_last else None
        skip, self._skip = self._skip, 0
        self._emitted = 0
        for pos, batch in enumerate(self._iter_unbounded(), start=1):
            if budget is not None and pos > budget:
                return
            self._emitted = pos
            if pos <= skip:
                continue  # resume fast-forward: consumed before the restart
            yield batch

    def _iter_unbounded(self) -> Iterator[dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed, self._epoch))
        files = list(self.files)
        if self._shard_by_file:
            files = files[self.process_index :: self.process_count]
        if self.shuffle:
            rng.shuffle(files)

        def raw_batches():
            stride_pos = 0
            for d in self._files_batches(files):
                if not self._shard_by_file and self.process_count > 1:
                    # strided slice so every host sees a disjoint subset
                    n = len(next(iter(d.values())))
                    idx = np.arange(
                        (self.process_index - stride_pos) % self.process_count,
                        n,
                        self.process_count,
                    )
                    stride_pos = (stride_pos + n) % self.process_count
                    d = _take(d, idx)
                yield d

        pool: list[dict[str, np.ndarray]] = []
        pooled = 0
        pending: list[dict[str, np.ndarray]] = []
        pend_n = 0

        def emit(d):
            nonlocal pending, pend_n
            pending.append(d)
            pend_n += len(next(iter(d.values())))
            while pend_n >= self.batch_size:
                rows = _concat_rows(pending)
                n = len(next(iter(rows.values())))
                yield _take(rows, slice(0, self.batch_size))
                rest = _take(rows, slice(self.batch_size, n))
                pending = [rest]
                pend_n = n - self.batch_size

        for d in raw_batches():
            if not self.shuffle:
                yield from emit(d)
                continue
            pool.append(d)
            pooled += len(next(iter(d.values())))
            if pooled >= self.buffer_size:
                rows = _concat_rows(pool)
                perm = rng.permutation(pooled)
                half = pooled // 2  # emit half, keep half for further mixing
                yield from emit(_take(rows, perm[:half]))
                pool = [_take(rows, perm[half:])]
                pooled -= half
        if pool:
            rows = _concat_rows(pool)
            yield from emit(_take(rows, rng.permutation(pooled)))
        if pend_n and not self.drop_last:
            yield _concat_rows(pending)


def _check_cursor_seed(state: dict[str, int], seed: int) -> None:
    if int(state.get("seed", seed)) != seed:
        raise ValueError(
            f"stream cursor was recorded with seed {state['seed']}, this "
            f"stream uses {seed} — resuming would yield a different batch "
            "sequence")


def load_parquet_table(files: Sequence[str],
                       columns: Sequence[str] | None = None) -> dict[str, np.ndarray]:
    """Map-style: read everything into memory (``jax-flax/train.py:52-60``)."""
    tables = [pq.read_table(f, columns=list(columns) if columns else None) for f in files]
    return _to_numpy_columns(pa.concat_tables(tables).combine_chunks())


class MapStream:
    """Map-style epochs over an in-memory table, presenting the same
    interface as :class:`ParquetStream` (``config streaming = false``;
    ``jax-flax/train.py:52-70`` full-permutation loader parity).

    One data slice only: the whole table lives on this host, so multi-host
    budget logic does not apply (use the streaming loader on pods).
    ``process_count`` (default: the process group's size) is the number of
    data slices; ranks that share one (model shards) all read the table.
    """

    def __init__(self, files: Sequence[str], batch_size: int, *,
                 shuffle: bool = True, seed: int = 42, drop_last: bool = True,
                 columns: Sequence[str] | None = None,
                 process_count: int | None = None):
        if (_process_index_count()[1] if process_count is None
                else process_count) > 1:
            raise ValueError(
                "streaming=false (map-style) loading is single-process only; "
                "multi-host runs need the streaming loader's per-host budgets"
            )
        self.table = load_parquet_table(files, columns)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        self._skip = 0
        self._emitted = 0
        self._n = len(next(iter(self.table.values())))

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        self._skip = 0

    def max_batches_per_host(self) -> int:
        """Batches of an epoch (one host): drop_last floors, else ceils."""
        if self.drop_last:
            return self._n // self.batch_size
        return -(-self._n // self.batch_size)

    def state_dict(self) -> dict[str, int]:
        """Same cursor contract as :meth:`ParquetStream.state_dict`."""
        return {"seed": int(self.seed), "epoch": int(self._epoch),
                "batches_emitted": int(self._emitted)}

    def load_state_dict(self, state: dict[str, int]) -> None:
        """Resume mid-epoch; the skip is index arithmetic into the epoch's
        permutation, no replay."""
        _check_cursor_seed(state, self.seed)
        self._epoch = int(state["epoch"])
        self._skip = int(state["batches_emitted"])

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        skip, self._skip = self._skip, 0
        self._emitted = skip
        idx = np.arange(self._n)
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(idx)
        end = self._n - self._n % self.batch_size if self.drop_last else self._n
        for i in range(skip * self.batch_size, end, self.batch_size):
            self._emitted += 1
            yield _take(self.table, idx[i : i + self.batch_size])


def prefetch_to_device(it, device, *, size: int = 2):
    """Double-buffered host->device transfer (``prefetch_to_mesh``'s
    counterpart on one device).

    Each numpy column is copied into pinned host memory and sent with
    ``non_blocking=True``, so the copy of batch N+1 overlaps the compute of
    batch N on PyTorch's current stream; ``size`` batches are kept in flight.
    On a CPU device the columns are wrapped without a copy.  Yields dicts of
    tensors with the same keys."""
    import collections

    device = torch.device(device)

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        return out

    q = collections.deque()
    it = iter(it)
    for b in it:
        q.append(put(b))
        if len(q) >= size:
            break
    while q:
        b = q.popleft()
        nxt = next(it, None)
        if nxt is not None:
            q.append(put(nxt))
        yield b
