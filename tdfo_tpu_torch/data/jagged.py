"""Jagged (ragged) tensors — port of ``tdfo_tpu/data/jagged.py``.

A ragged feature is ``(values[N], lengths[B])``: ``B`` rows flattened into
``values`` with a static capacity ``N >= sum(lengths)``; slots past the
packed payload hold zeros.  Offsets are derived (``cumsum(lengths)``), not
stored.  The jagged Bert4Rec path packs each host batch with
:func:`pack_rows` and turns it back into ``[B, T]`` ids with
:func:`jagged_to_dense_per_host` inside the train step, on the device.

These are plain tensor gathers (the reference's are single fused XLA
gathers too): there is no TPU kernel behind them, so none here either.
Ids and lengths are int32 as in the reference; outputs equal its bit for
bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "JaggedTensor",
    "dense_to_jagged",
    "jagged_to_dense",
    "jagged_to_dense_per_host",
    "lengths_to_offsets",
    "pack_rows",
]


def lengths_to_offsets(lengths: torch.Tensor) -> torch.Tensor:
    """[B] lengths -> [B+1] exclusive offsets (int32)."""
    lengths = torch.as_tensor(lengths)
    zero = torch.zeros((1,), dtype=torch.int32, device=lengths.device)
    return torch.cat([zero, torch.cumsum(lengths, 0, dtype=torch.int32)])


def _gather_rows(values: torch.Tensor, base: torch.Tensor, lengths: torch.Tensor,
                 max_len: int, pad_value) -> torch.Tensor:
    """``[B, max_len(, D)]``: row ``i`` reads ``values[base[i] + t]`` for
    ``t < lengths[i]`` (the head of a longer row), ``pad_value`` after."""
    pos = torch.arange(max_len, dtype=torch.int32, device=values.device)[None, :]
    valid = pos < lengths[:, None]
    idx = torch.where(valid, base[:, None] + pos, 0).to(torch.int64)
    dense = values[idx]
    mask = valid if dense.dim() == 2 else valid[..., None]
    return torch.where(mask, dense, torch.as_tensor(pad_value, dtype=dense.dtype,
                                                   device=dense.device))


def jagged_to_dense(values: torch.Tensor, lengths: torch.Tensor, max_len: int,
                    pad_value=0) -> torch.Tensor:
    """``[N] -> [B, max_len]`` (or ``[N, D] -> [B, max_len, D]``), fbgemm
    ``jagged_2d_to_dense`` semantics: rows longer than ``max_len`` keep
    their head, shorter ones are padded with ``pad_value``."""
    return _gather_rows(values, lengths_to_offsets(lengths)[:-1], lengths,
                        max_len, pad_value)


def jagged_to_dense_per_host(values: torch.Tensor, lengths: torch.Tensor,
                             max_len: int, pad_value=0,
                             n_hosts: int = 1) -> torch.Tensor:
    """:func:`jagged_to_dense` for values packed PER HOST: each of
    ``n_hosts`` processes packs its own ``B / n_hosts`` rows into its own
    ``N / n_hosts`` slice of ``values``, so offsets restart at every host
    boundary.  ``n_hosts = 1`` is exactly :func:`jagged_to_dense`."""
    if n_hosts <= 1:
        return jagged_to_dense(values, lengths, max_len, pad_value)
    b = lengths.shape[0]
    if b % n_hosts or values.shape[0] % n_hosts:
        raise ValueError(
            f"jagged_to_dense_per_host: batch ({b}) and values capacity "
            f"({values.shape[0]}) must both divide by n_hosts ({n_hosts}); "
            "uneven splits would mis-segment host boundaries")
    rows_per_host = b // n_hosts
    cap_per_host = values.shape[0] // n_hosts
    off = torch.cumsum(lengths, 0, dtype=torch.int32) - lengths  # global exclusive
    host = torch.arange(b, dtype=torch.int32, device=lengths.device) // rows_per_host
    host_start = off[(host * rows_per_host).to(torch.int64)]
    base = host * cap_per_host + (off - host_start)
    return _gather_rows(values, base, lengths, max_len, pad_value)


def dense_to_jagged(dense: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``[B, T(, D)] -> [B*T(, D)]`` packed values (fbgemm ``dense_to_jagged``):
    the valid entries left-compacted in row-major order by a stable sort on
    validity; slots past ``sum(lengths)`` hold 0."""
    b, t = dense.shape[0], dense.shape[1]
    pos = torch.arange(t, dtype=torch.int32, device=dense.device)[None, :]
    valid = (pos < lengths[:, None]).reshape(-1)
    flat = dense.reshape((b * t,) + tuple(dense.shape[2:]))
    order = torch.argsort((~valid).to(torch.int32), stable=True)
    packed = flat[order]
    keep = valid[order]
    mask = keep if packed.dim() == 1 else keep[:, None]
    return torch.where(mask, packed, torch.zeros((), dtype=packed.dtype,
                                                 device=packed.device))


def pack_rows(rows, capacity: int, dtype=np.int32) -> tuple[np.ndarray, np.ndarray]:
    """Host side: variable-length rows -> ``(values[capacity], lengths[B])``
    numpy arrays with a zero tail (the loader's ragged object columns feed
    straight in)."""
    lengths = np.fromiter((len(r) for r in rows), np.int32, len(rows))
    n = int(lengths.sum())
    if capacity < n:
        raise ValueError(f"capacity {capacity} < total jagged length {n}")
    values = np.zeros((capacity,), dtype)
    if n:
        values[:n] = np.concatenate([np.asarray(r, dtype) for r in rows])
    return values, lengths


@dataclass(frozen=True)
class JaggedTensor:
    """One ragged feature: ``values`` (``[N]`` ids or ``[N, D]``) with
    per-row ``lengths`` (``[B]`` int32); ``values.shape[0]`` is the static
    capacity."""

    values: torch.Tensor
    lengths: torch.Tensor

    @property
    def offsets(self) -> torch.Tensor:
        """Exclusive offsets, shape [B+1]."""
        return lengths_to_offsets(self.lengths)

    @property
    def batch_size(self) -> int:
        return self.lengths.shape[0]

    def to_dense(self, max_len: int, pad_value=0) -> torch.Tensor:
        return jagged_to_dense(self.values, self.lengths, max_len, pad_value)

    @classmethod
    def from_dense(cls, dense: torch.Tensor, lengths: torch.Tensor) -> "JaggedTensor":
        """Inverse of :meth:`to_dense` with capacity ``B * max_len``."""
        return cls(values=dense_to_jagged(dense, lengths), lengths=lengths)

    @classmethod
    def from_lists(cls, rows, capacity: int | None = None,
                   dtype=np.int32) -> "JaggedTensor":
        """Host-side constructor (KJT ``from_lengths_sync``)."""
        n = sum(len(r) for r in rows)
        values, lengths = pack_rows(rows, capacity or n, dtype)
        return cls(values=torch.from_numpy(values), lengths=torch.from_numpy(lengths))
