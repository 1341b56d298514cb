"""Row-sparse gradient aggregation + optimizer updates — port of the subset
of ``tdfo_tpu/ops/sparse.py`` that the TwoTower sparse training step runs.

fbgemm-style in-backward sparse optimizers: the step computes gradients with
respect to the GATHERED rows, merges duplicate ids, and updates only the
touched rows of table + optimizer state.  Three tiers, as in the reference:

* fat-line tables (``[L, T, 128]``, every kind): :func:`fat_update` — one
  line-aware dedupe, one segment-sum, one ``fat_line_update`` kernel launch
  (``ops/kernels/fat_line_update.py``).  The dedup-lookup step takes the
  routed form instead: :func:`dedupe_rows_and_lines` (one sort for the
  forward's line gather, the row expand and the update) and
  :func:`fat_apply_routed`, one ``fat_line_update_routed`` launch on
  row-level summed grads (``ops/kernels/fat_line_update_routed.py``);
  :func:`fat_apply_unique` serves pre-deduplicated row ids;
* small plain adam tables (``<= small_vocab_threshold`` rows):
  :func:`dense_lazy_adam` — a dense masked sweep, no dedupe;
* other plain tables: :func:`dedupe_grads` + ``sparse_{sgd,adam,adagrad,
  rowwise_adagrad}``.

PyTorch idiom: every update mutates its table and slot tensors IN PLACE
(the reference donated them) and returns them; clone first to keep the old
values.  Adam's global step count is a 0-dim int32 tensor on the table's
device, so bias corrections never sync to the host.  Storage-dtype knobs
(bf16/int8 tables, bf16 slots, stochastic rounding) and the update cache
are not ported yet (``ROADMAP.md`` Queue A item 13).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from tdfo_tpu_torch.ops.fat_lines import line_layout
from tdfo_tpu_torch.ops.kernels.fat_line_update import (
    SENTINEL,
    fat_line_update,
)
from tdfo_tpu_torch.ops.kernels.fat_line_update_routed import (
    fat_line_update_routed,
)

__all__ = [
    "dedupe_grads",
    "dedupe_ids",
    "dedupe_rows_and_lines",
    "sparse_sgd",
    "sparse_adam",
    "sparse_adagrad",
    "sparse_rowwise_adagrad",
    "dense_lazy_adam",
    "fat_update",
    "fat_apply_routed",
    "fat_apply_unique",
    "SparseOptimizer",
    "sparse_optimizer",
]


def _check_capacity(b, capacity, vocab_bound, max_distinct, what):
    if (capacity < b and (vocab_bound is None or capacity < vocab_bound)
            and (max_distinct is None or capacity < max_distinct)):
        raise ValueError(
            f"{what}: capacity {capacity} < batch {b} is only safe when a "
            f"static bound proves distinct ids fit (vocab or max_distinct "
            f"<= capacity); got vocab bound={vocab_bound}, "
            f"max_distinct={max_distinct}.  Undersizing would silently DROP "
            "the largest-id updates, so it is rejected.")


def _dedupe_ids_impl(ids: torch.Tensor, capacity: int, r: int = 1):
    """Sort-based dedupe (the reference's single-sort formulation): ranks
    the ids, assigns each sorted position its group slot by a cumsum over
    first occurrences, and carries the slot back to the original position.
    Negative ids map to the int32-max sentinel, which sorts to the top and
    never becomes a valid slot.  Integer outputs equal the reference's."""
    ids = ids.to(torch.int64)
    b = ids.shape[0]
    oob = SENTINEL
    clean = torch.where(ids >= 0, ids, torch.full_like(ids, oob))
    sorted_ids, order = torch.sort(clean)
    ok = sorted_ids < oob
    if r > 1:
        key = torch.where(ok, sorted_ids // r, torch.full_like(sorted_ids, oob))
        slot = torch.where(ok, sorted_ids % r, torch.zeros_like(sorted_ids))
    else:
        key = sorted_ids
    first = torch.ones_like(key, dtype=torch.bool)
    if b > 1:
        first[1:] = key[1:] != key[:-1]
    uidx = torch.cumsum(first.to(torch.int64), 0) - 1
    segidx = uidx if r == 1 else uidx * r + slot
    seg = torch.empty_like(segidx)
    seg[order] = segidx
    uids = torch.full((capacity,), oob, dtype=torch.int64, device=ids.device)
    keep = uidx < capacity  # overflow past a licensed capacity drops
    uids[uidx[keep]] = key[keep]
    valid = uids < oob
    return uids.to(torch.int32), seg, valid


def dedupe_ids(ids: torch.Tensor, *, capacity: int | None = None,
               vocab: int | None = None, max_distinct: int | None = None,
               rows_per_line: int = 1):
    """``ids[B] -> (uids[C] int32, seg[B] int64, valid[C] bool)`` with
    ``ids == uids[seg]`` for non-negative ids (reference
    ``dedupe_ids``).  With ``rows_per_line`` R > 1 the grouping key is the
    LINE id and ``seg`` indexes the ``C x R`` line-slot space
    (``seg = line_slot * R + row % R``).  Sentinel = int32 max."""
    b = ids.shape[0]
    capacity = capacity or b
    r = rows_per_line
    vocab_bound = None if vocab is None else -(-vocab // r)
    _check_capacity(b, capacity, vocab_bound, max_distinct, "dedupe_ids")
    return _dedupe_ids_impl(ids, capacity, r)


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` with out-of-range segments dropped."""
    keep = (seg >= 0) & (seg < n)
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg[keep], x[keep])


def dedupe_grads(ids: torch.Tensor, grads: torch.Tensor, *,
                 capacity: int | None = None, vocab: int | None = None,
                 max_distinct: int | None = None):
    """Merge duplicate row ids: ``(ids[B], grads[B,D]) -> (uids[C], g[C,D],
    valid[C])``; padding slots carry the sentinel, a zero grad and
    ``valid = False``.  Sums are f32."""
    b = ids.shape[0]
    capacity = capacity or b
    _check_capacity(b, capacity, vocab, max_distinct, "dedupe_grads")
    uids, seg, valid = _dedupe_ids_impl(ids, capacity)
    g = _segment_sum(grads.to(torch.float32), seg, capacity)
    g = torch.where(valid[:, None], g, torch.zeros_like(g))
    return uids, g, valid


def _scatter_rows(dst, uids, valid, new_rows):
    """``dst[uids[valid]] = new_rows[valid]`` in place."""
    u = uids.to(torch.int64)[valid]
    dst.index_copy_(0, u, new_rows[valid].to(dst.dtype))


def _gather_rows(t, uids, valid):
    idx = torch.where(valid, uids.to(torch.int64), torch.zeros_like(uids, dtype=torch.int64))
    return t[idx].to(torch.float32)


def sparse_sgd(table, uids, g, valid, *, lr: float, weight_decay: float = 0.0):
    """fbgemm EXACT_SGD parity: touched rows only, wd on touched rows."""
    rows = _gather_rows(table, uids, valid)
    g = g.to(torch.float32) + weight_decay * rows
    _scatter_rows(table, uids, valid, rows - lr * g)
    return table


def sparse_adam(table, mu, nu, count, uids, g, valid, *, lr, b1=0.9,
                b2=0.999, eps=1e-8, weight_decay=0.0):
    """Row-sparse AdamW: per-row moments, global-step bias correction,
    decoupled weight decay on gathered rows only.  ``count`` is advanced in
    place.  Returns ``(table, mu, nu, count)``."""
    rows = _gather_rows(table, uids, valid)
    mu_r = _gather_rows(mu, uids, valid)
    nu_r = _gather_rows(nu, uids, valid)
    g = g.to(torch.float32)
    count += 1
    t = count.to(torch.float32)
    mu_n = b1 * mu_r + (1 - b1) * g
    nu_n = b2 * nu_r + (1 - b2) * g * g
    mu_hat = mu_n / (1 - b1**t)
    nu_hat = nu_n / (1 - b2**t)
    delta = lr * (mu_hat / (torch.sqrt(nu_hat) + eps) + weight_decay * rows)
    _scatter_rows(table, uids, valid, rows - delta)
    _scatter_rows(mu, uids, valid, mu_n)
    _scatter_rows(nu, uids, valid, nu_n)
    return table, mu, nu, count


def sparse_rowwise_adagrad(table, accum, uids, g, valid, *, lr, eps=1e-10,
                           weight_decay=0.0):
    """fbgemm EXACT_ROWWISE_ADAGRAD parity: ONE f32 accumulator per row
    (mean of squared grads)."""
    rows = _gather_rows(table, uids, valid)
    acc_r = _gather_rows(accum, uids, valid)
    g = g.to(torch.float32) + weight_decay * rows
    acc_n = acc_r + torch.mean(g * g, dim=-1)
    delta = lr * g / (torch.sqrt(acc_n)[:, None] + eps)
    _scatter_rows(table, uids, valid, rows - delta)
    _scatter_rows(accum, uids, valid, acc_n)
    return table, accum


def sparse_adagrad(table, accum, uids, g, valid, *, lr, eps=1e-10,
                   weight_decay=0.0):
    """fbgemm EXACT_ADAGRAD parity (elementwise squared-grad accumulator)."""
    rows = _gather_rows(table, uids, valid)
    acc_r = _gather_rows(accum, uids, valid)
    g = g.to(torch.float32) + weight_decay * rows
    acc_n = acc_r + g * g
    delta = lr * g / (torch.sqrt(acc_n) + eps)
    _scatter_rows(table, uids, valid, rows - delta)
    _scatter_rows(accum, uids, valid, acc_n)
    return table, accum


def dense_lazy_adam(table, mu, nu, count, ids, grads, *, lr, b1=0.9,
                    b2=0.999, eps=1e-8, weight_decay=0.0):
    """Small-vocab tier: per-row summed grads (``index_add_``) and the
    touched mask, then one dense masked sweep over the whole [V, D] table.
    Semantics equal :func:`sparse_adam`: untouched rows do not decay
    (moments, weight decay), bias correction uses the global step, and
    negative or out-of-range ids contribute nothing.  In place; returns
    ``(table, mu, nu, count)``."""
    v = table.shape[0]
    ids = ids.reshape(-1).to(torch.int64)
    grads = grads.reshape(-1, grads.shape[-1]).to(torch.float32)
    ok = (ids >= 0) & (ids < v)
    gsum = torch.zeros((v, grads.shape[1]), dtype=torch.float32,
                       device=table.device).index_add_(0, ids[ok], grads[ok])
    touched = torch.zeros((v,), dtype=torch.bool, device=table.device)
    touched[ids[ok]] = True
    touched = touched[:, None]
    count += 1
    t = count.to(torch.float32)
    tf = table.to(torch.float32)
    mu_n = b1 * mu + (1 - b1) * gsum
    nu_n = b2 * nu + (1 - b2) * gsum * gsum
    mu_hat = mu_n / (1 - b1**t)
    nu_hat = nu_n / (1 - b2**t)
    delta = lr * (mu_hat / (torch.sqrt(nu_hat) + eps) + weight_decay * tf)
    table.copy_(torch.where(touched, tf - delta, table))
    mu.copy_(torch.where(touched, mu_n, mu))
    nu.copy_(torch.where(touched, nu_n, nu))
    return table, mu, nu, count


def dedupe_rows_and_lines(ids: torch.Tensor, *, capacity_rows: int,
                          capacity_lines: int, rows_per_line: int):
    """Row- AND line-level dedupe from one sort (reference
    ``dedupe_rows_and_lines``, the routed fat-line path): ``ids[B] ->
    (seg_row[B] int64, ulines[CL] int32, row_lidx[CR] int32, row_slot[CR]
    int32)``.  ``seg_row`` maps each position to its distinct-row slot;
    ``ulines`` are the distinct line ids, sorted, int32-max sentinels at the
    top; ``row_lidx`` / ``row_slot`` give each distinct row its line slot
    and its slot within the line, and unused row slots hold
    ``capacity_lines``.  Negative ids group under the sentinel line with
    slot 0.  Groups past a capacity drop, as the reference's
    ``mode="drop"`` scatters do.  Integer outputs equal the reference's."""
    r = rows_per_line
    ids = ids.to(torch.int64)
    clean = torch.where(ids >= 0, ids, torch.full_like(ids, SENTINEL))
    sorted_ids, order = torch.sort(clean)
    ok = sorted_ids < SENTINEL

    def group_index(key):
        first = torch.ones_like(key, dtype=torch.bool)
        first[1:] = key[1:] != key[:-1]
        return torch.cumsum(first.to(torch.int64), 0) - 1

    uidx = group_index(sorted_ids)
    line = torch.where(ok, sorted_ids // r, torch.full_like(sorted_ids, SENTINEL))
    slot = torch.where(ok, sorted_ids % r, torch.zeros_like(sorted_ids))
    lidx = group_index(line)
    seg_row = torch.empty_like(uidx)
    seg_row[order] = uidx
    dev = ids.device
    ulines = torch.full((capacity_lines,), SENTINEL, dtype=torch.int64, device=dev)
    keep = lidx < capacity_lines
    ulines[lidx[keep]] = line[keep]
    row_lidx = torch.full((capacity_rows,), capacity_lines, dtype=torch.int64,
                          device=dev)
    row_slot = torch.zeros((capacity_rows,), dtype=torch.int64, device=dev)
    keep = uidx < capacity_rows
    row_lidx[uidx[keep]] = lidx[keep]
    row_slot[uidx[keep]] = slot[keep]
    return (seg_row, ulines.to(torch.int32), row_lidx.to(torch.int32),
            row_slot.to(torch.int32))


def _bias_corrections(layout, slots, b1, b2, device):
    """``corr [2]`` f32 for the fat kernels: adam advances its step count
    in place and gets ``(1 - b1^t, 1 - b2^t)`` on the device (no host
    sync); the other kinds ignore it."""
    if layout.kind != "adam":
        return torch.zeros((2,), dtype=torch.float32, device=device)
    (count,) = slots
    count += 1
    t = count.to(torch.float32)
    return torch.stack([1.0 - b1**t, 1.0 - b2**t])


def _fat_apply_lines(fat, slots, ulines, g_slots, touched, *, layout, lr,
                     b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
    """Line-level dispatch (reference ``_fat_apply_lines``): bias
    corrections on the device, then one :func:`fat_line_update` call — row
    form when one row fills a line, packed form with the touched mask
    otherwise.  ``g_slots``: [C*R, d] summed grads in line-slot order;
    ``touched``: [C*R] occupancy (> 0 = touched) or None with R == 1.
    Returns ``(fat, slots)``."""
    corr = _bias_corrections(layout, slots, b1, b2, fat.device)
    c = ulines.shape[0]
    g_slots = g_slots.to(torch.float32)
    kw = dict(layout=layout, lr=lr, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
    if layout.r == 1:
        fat_line_update(fat, ulines, g_slots.reshape(c, layout.d).contiguous(),
                        None, corr, **kw)
    else:
        tl = (touched.reshape(c, layout.r) > 0).to(torch.float32)
        fat_line_update(fat, ulines,
                        g_slots.reshape(c, layout.r, layout.d).contiguous(),
                        tl.contiguous(), corr, **kw)
    return fat, slots


def fat_update(fat, slots, ids, grads, *, embedding_dim, kind, lr, b1=0.9,
               b2=0.999, eps=1e-8, weight_decay=0.0,
               capacity: int | None = None, max_distinct: int | None = None):
    """Big-table tier: fused in-backward optimizer over packed fat lines.
    One line-aware dedupe + one segment-sum build the kernel operands
    directly.  ``capacity``/``max_distinct`` bound distinct LINES.
    In place; returns ``(fat, slots)``."""
    layout = line_layout(embedding_dim, kind)
    r = layout.r
    ids = ids.reshape(-1)
    grads = grads.reshape(-1, grads.shape[-1])
    ulines, seg, _valid = dedupe_ids(
        ids, capacity=capacity, vocab=fat.shape[0] * r,
        max_distinct=max_distinct, rows_per_line=r)
    c = ulines.shape[0]
    g_slots = _segment_sum(grads.to(torch.float32), seg, c * r)
    touched = None if r == 1 else _segment_sum(
        (ids >= 0).to(torch.float32), seg, c * r)
    return _fat_apply_lines(
        fat, slots, ulines, g_slots, touched, layout=layout, lr=lr, b1=b1,
        b2=b2, eps=eps, weight_decay=weight_decay)


def _lines_from_unique(uids, g, valid, layout):
    """Row-level uniques -> line-level operands (reference
    ``_lines_from_unique``).  ``uids`` arrive sorted with sentinels at the
    top, so their line ids are sorted too and a first-occurrence cumsum
    assigns line slots without a second sort.  Returns ``(ulines[C],
    g_slots[C*R, d], touched[C*R])`` with C the row capacity."""
    r = layout.r
    cap = uids.shape[0]
    uids = uids.to(torch.int64)
    line = torch.where(valid, uids // r, torch.full_like(uids, SENTINEL))
    slot = torch.where(valid, uids % r, torch.zeros_like(uids))
    first = torch.ones_like(line, dtype=torch.bool)
    first[1:] = line[1:] != line[:-1]
    lidx = torch.cumsum(first.to(torch.int64), 0) - 1
    ulines = torch.full((cap,), SENTINEL, dtype=torch.int64, device=uids.device)
    ulines[lidx] = line
    # every sentinel row shares one line id -> one slot, which stays oob
    seg2 = torch.where(valid, lidx * r + slot, torch.full_like(lidx, cap * r))
    g_slots = _segment_sum(g.to(torch.float32), seg2, cap * r)
    touched = (_segment_sum(valid.to(torch.float32), seg2, cap * r) > 0
               ).to(torch.float32)
    return ulines.to(torch.int32), g_slots, touched


def fat_apply_unique(fat, slots, uids, g, valid=None, *, embedding_dim, kind,
                     lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
    """Fused fat-line step on pre-deduplicated row-level ``(uids, g)``
    (reference ``fat_apply_unique``): ``uids`` sorted ascending with
    int32-max sentinels at the top (the :func:`dedupe_grads` layout).  One
    :func:`fat_line_update` launch.  In place; returns ``(fat, slots)``."""
    layout = line_layout(embedding_dim, kind, fat.dtype)
    if valid is None:
        valid = uids < SENTINEL
    ulines, g_slots, touched = _lines_from_unique(uids, g, valid, layout)
    return _fat_apply_lines(
        fat, slots, ulines, g_slots, touched, layout=layout, lr=lr, b1=b1,
        b2=b2, eps=eps, weight_decay=weight_decay)


def fat_apply_routed(fat, slots, ulines, g_u, row_lidx, row_slot, lines, *,
                     embedding_dim, kind, lr, b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=0.0, sr_key=None):
    """Fused fat-line step on row-level summed grads ``g_u [CR, d]`` plus
    the routing of :func:`dedupe_rows_and_lines` (reference
    ``fat_apply_routed``): the C x R slot-space segment-sum never exists.
    ``lines [CL, T, 128]`` is the forward's gather of ``fat`` at ``ulines``
    (sentinels read line 0); the kernel reads the touched rows' state from
    it.  One ``fat_line_update_routed`` launch; in place; returns ``(fat,
    slots)``.  The reference's int8 byte lines and its stochastic-rounding
    key belong to ``ROADMAP.md`` Queue A item 13 and refuse here."""
    if sr_key is not None:
        raise NotImplementedError(
            "fat_apply_routed: stochastic rounding (sr_key) is not ported "
            "yet (ROADMAP.md Queue A item 13)")
    layout = line_layout(embedding_dim, kind, fat.dtype)
    corr = _bias_corrections(layout, slots, b1, b2, fat.device)
    fat_line_update_routed(
        fat, lines, ulines, row_lidx, row_slot, g_u.to(torch.float32), corr,
        layout=layout, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return fat, slots


@dataclass(frozen=True)
class SparseOptimizer:
    """``init(table) -> slots``, ``update(table, slots, ids, grads) ->
    (table, slots)`` with the reference's tier dispatch
    (``tdfo_tpu/ops/sparse.py::SparseOptimizer.update``): fat lines
    (``table.dim() == 3``, any kind) -> :func:`fat_update`; small plain adam
    tables -> :func:`dense_lazy_adam`; other plain tables -> dedupe +
    ``sparse_*``."""

    kind: str  # "sgd" | "adam" | "adagrad" | "rowwise_adagrad"
    lr: float
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    small_vocab_threshold: int = 16384
    slot_dtype: str = "float32"

    def __post_init__(self) -> None:
        if self.kind not in ("sgd", "adam", "adagrad", "rowwise_adagrad"):
            raise ValueError(f"unknown sparse optimizer kind: {self.kind!r}")
        if self.slot_dtype != "float32":
            raise NotImplementedError(
                "slot_dtype other than float32 is not ported yet "
                "(ROADMAP.md Queue A item 13)")

    def init(self, table: torch.Tensor) -> Any:
        dev = table.device
        count = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
        if table.dim() == 3:  # fat lines carry their own optimizer state
            return (count(),) if self.kind == "adam" else ()
        if self.kind == "sgd":
            return ()
        if self.kind == "adagrad":
            return (torch.zeros_like(table, dtype=torch.float32),)
        if self.kind == "rowwise_adagrad":
            return (torch.zeros((table.shape[0],), dtype=torch.float32,
                                device=dev),)
        return (torch.zeros_like(table, dtype=torch.float32),
                torch.zeros_like(table, dtype=torch.float32), count())

    def update_routed(self, table, slots, ulines, g_u, row_lidx, row_slot,
                      lines, *, embedding_dim: int):
        """Fat-line routed path of the dedup-lookup step: row-level summed
        grads plus the routing of :func:`dedupe_rows_and_lines`, and the
        forward's line gather ``lines`` (:func:`fat_apply_routed`)."""
        if table.dim() != 3:
            raise ValueError("update_routed is the fat-line path")
        return fat_apply_routed(
            table, slots, ulines, g_u, row_lidx, row_slot, lines,
            embedding_dim=embedding_dim, kind=self.kind, lr=self.lr,
            b1=self.b1, b2=self.b2, eps=self.eps,
            weight_decay=self.weight_decay)

    def update_unique(self, table, slots, uids, g, valid, *,
                      embedding_dim: int | None = None):
        """Tier dispatch on PRE-deduplicated ``(uids, g, valid)`` (the
        dedup-lookup step's path): fat lines take :func:`fat_apply_unique`,
        plain tables ``sparse_*`` (the small-vocab dense tier needs raw ids
        and is bypassed; ``sparse_adam`` has its semantics)."""
        if table.dim() == 3:
            if embedding_dim is None:
                raise ValueError("fat-table update needs embedding_dim")
            return fat_apply_unique(
                table, slots, uids, g, valid, embedding_dim=embedding_dim,
                kind=self.kind, lr=self.lr, b1=self.b1, b2=self.b2,
                eps=self.eps, weight_decay=self.weight_decay)
        kw = dict(lr=self.lr, weight_decay=self.weight_decay)
        if self.kind == "sgd":
            return sparse_sgd(table, uids, g, valid, **kw), slots
        if self.kind == "adagrad":
            table, acc = sparse_adagrad(table, slots[0], uids, g, valid,
                                        eps=self.eps, **kw)
            return table, (acc,)
        if self.kind == "rowwise_adagrad":
            table, acc = sparse_rowwise_adagrad(table, slots[0], uids, g,
                                                valid, eps=self.eps, **kw)
            return table, (acc,)
        mu, nu, count = slots
        table, mu, nu, count = sparse_adam(
            table, mu, nu, count, uids, g, valid, b1=self.b1, b2=self.b2,
            eps=self.eps, **kw)
        return table, (mu, nu, count)

    def update(self, table, slots, ids, grads, *,
               embedding_dim: int | None = None,
               capacity: int | None = None, max_distinct: int | None = None):
        if table.dim() == 3:
            if embedding_dim is None:
                raise ValueError("fat-table update needs embedding_dim")
            return fat_update(
                table, slots, ids, grads, embedding_dim=embedding_dim,
                kind=self.kind, lr=self.lr, b1=self.b1, b2=self.b2,
                eps=self.eps, weight_decay=self.weight_decay,
                capacity=capacity, max_distinct=max_distinct)
        if (self.kind == "adam"
                and table.shape[0] <= self.small_vocab_threshold):
            mu, nu, count = slots
            table, mu, nu, count = dense_lazy_adam(
                table, mu, nu, count, ids, grads, lr=self.lr, b1=self.b1,
                b2=self.b2, eps=self.eps, weight_decay=self.weight_decay)
            return table, (mu, nu, count)
        uids, g, valid = dedupe_grads(
            ids.reshape(-1), grads.reshape(-1, grads.shape[-1]),
            capacity=capacity, vocab=table.shape[0], max_distinct=max_distinct)
        return self.update_unique(table, slots, uids, g, valid,
                                  embedding_dim=embedding_dim)


def sparse_optimizer(kind: str, lr: float, weight_decay: float = 0.0,
                     **kw) -> SparseOptimizer:
    return SparseOptimizer(kind=kind, lr=lr, weight_decay=weight_decay, **kw)
