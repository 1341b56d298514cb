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
device, so bias corrections never sync to the host.

Storage dtypes: tables and adam/adagrad slots may be stored in bf16
(``SparseOptimizer(slot_dtype="bfloat16")``; rowwise_adagrad's per-row
accumulator stays f32).  Gathered rows widen to f32, all math runs in f32,
and each write requantizes through ``ops.quant.quantize``: stochastic
rounding when an ``sr_key`` is given (``component_key(sr_key, i)`` per
written component, as the reference), round-to-nearest without, a plain
f32 cast for f32 storage.  The random bits cover the same block the
reference's cover (the ``[C, d]`` capacity block, or the whole ``[V, d]``
table in the ``dense_lazy_*`` tiers), so a bf16 write equals the JAX
package's bit for bit.  Fat lines pass ``_kernel_seed(sr_key)`` to the
kernels.

int8 storage is rowwise (``ops/quant.py``): plain int8 tables pass their
f32 ``[V, 2]`` (scale, offset) sidecar as ``qscale`` and get it back,
gathered rows decode through the stored grid, and every write requantizes
the new rows (:func:`~tdfo_tpu_torch.ops.quant.quantize_rows`) over the
same ``[C, d]`` block with the same key as the reference (the raw key for
sgd, ``component_key(key, 0)`` otherwise), so codes, sidecars and slots
are the JAX package's given the same f32 rows.  int8 fat lines (byte
containers) update row by row (:func:`_fat_apply_rows_int8`), never
through the fat-line kernels.  int8 tables never take the
``dense_lazy_*`` tiers, whose full-block requantize would re-grid every
untouched row.

The update cache (:meth:`SparseOptimizer.cache_init` ..
:meth:`SparseOptimizer.cache_flush`) keeps the touched rows of a plain
table (and their optimizer state) in a small device-resident directory
between flushes; the cached math is the ``sparse_*`` math, so a cached
run's flushed tables equal the uncached run's bit for bit.  Under a
device mesh every rank holds the same cache and runs its math on the same
global ids and grads (the reference's replicated ``shard_map``): only the
admission's gathers of a sharded table read across ranks (``gather``,
each row from its owner) and only the flush's write-back is per rank
(``owned``, each row into the shard that owns it).  With an
``obs/counters.py`` collector open, the cache reports its hit, miss,
unique, flushed and resident rows (the reference's ``counters.emit``
sites).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from tdfo_tpu_torch.obs import counters
from tdfo_tpu_torch.ops import threefry
from tdfo_tpu_torch.ops.fat_lines import fat_view, line_layout
from tdfo_tpu_torch.ops.kernels.fat_line_update import (
    SENTINEL,
    fat_line_update,
)
from tdfo_tpu_torch.ops.kernels.fat_line_update_routed import (
    fat_line_update_routed,
)
from tdfo_tpu_torch.ops.kernels.segment_sum import segment_sum
from tdfo_tpu_torch.ops.quant import (
    bytes_to_f32,
    component_key,
    dequantize_rows,
    f32_to_bytes,
    quantize,
    quantize_rows,
    storage_dtype,
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
    "dense_lazy_sgd",
    "dense_lazy_adagrad",
    "dense_lazy_rowwise_adagrad",
    "fat_update",
    "fat_apply_routed",
    "fat_apply_unique",
    "cache_route",
    "cache_lookup_rows",
    "cache_overlay_rows",
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


def _dedupe_ids_impl(ids: torch.Tensor, capacity: int, r: int = 1,
                     with_plan: bool = False):
    """Sort-based dedupe (the reference's single-sort formulation): ranks
    the ids, assigns each sorted position its group slot by a cumsum over
    first occurrences, and carries the slot back to the original position.
    Negative ids map to the int32-max sentinel, which sorts to the top and
    never becomes a valid slot.  Integer outputs equal the reference's.
    The sort is stable, and slots grow along it, so ``with_plan`` appends
    ``(order, sorted slots)``: the segment order :func:`_segment_sum`
    needs, without a second sort."""
    ids = ids.to(torch.int64)
    b = ids.shape[0]
    oob = SENTINEL
    clean = torch.where(ids >= 0, ids, torch.full_like(ids, oob))
    sorted_ids, order = torch.sort(clean, stable=True)
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
    if with_plan:
        return uids.to(torch.int32), seg, valid, (order, segidx)
    return uids.to(torch.int32), seg, valid


def dedupe_ids(ids: torch.Tensor, *, capacity: int | None = None,
               vocab: int | None = None, max_distinct: int | None = None,
               rows_per_line: int = 1, with_plan: bool = False):
    """``ids[B] -> (uids[C] int32, seg[B] int64, valid[C] bool)`` with
    ``ids == uids[seg]`` for non-negative ids (reference
    ``dedupe_ids``).  With ``rows_per_line`` R > 1 the grouping key is the
    LINE id and ``seg`` indexes the ``C x R`` line-slot space
    (``seg = line_slot * R + row % R``).  Sentinel = int32 max.
    ``with_plan`` appends the segment plan ``_segment_sum`` takes."""
    b = ids.shape[0]
    capacity = capacity or b
    r = rows_per_line
    vocab_bound = None if vocab is None else -(-vocab // r)
    _check_capacity(b, capacity, vocab_bound, max_distinct, "dedupe_ids")
    return _dedupe_ids_impl(ids, capacity, r, with_plan)


# ``jax.ops.segment_sum`` with out-of-range segments dropped, each segment
# summed in input order (bitwise the CPU's ``index_add_`` on the card too);
# a dedupe's ``with_plan`` output spares its sort
_segment_sum = segment_sum


def dedupe_grads(ids: torch.Tensor, grads: torch.Tensor, *,
                 capacity: int | None = None, vocab: int | None = None,
                 max_distinct: int | None = None):
    """Merge duplicate row ids: ``(ids[B], grads[B,D]) -> (uids[C], g[C,D],
    valid[C])``; padding slots carry the sentinel, a zero grad and
    ``valid = False``.  Sums are f32."""
    b = ids.shape[0]
    capacity = capacity or b
    _check_capacity(b, capacity, vocab, max_distinct, "dedupe_grads")
    uids, seg, valid, plan = _dedupe_ids_impl(ids, capacity, with_plan=True)
    g = _segment_sum(grads.to(torch.float32), seg, capacity, plan)
    g = torch.where(valid[:, None], g, torch.zeros_like(g))
    return uids, g, valid


def _scatter_rows(dst, uids, valid, new_rows, key=None, qscale=None):
    """``dst[uids[valid]] = quantize(new_rows)[valid]`` in place: the whole
    ``[C, ...]`` block requantizes to ``dst``'s storage dtype (its random
    bits are those the reference draws over the same block), then the
    valid rows scatter.  int8 ``dst`` (``qscale`` its sidecar): the block's
    rows are re-gridded (:func:`quantize_rows`) and codes and sidecar rows
    scatter together."""
    u = uids.to(torch.int64)[valid]
    if qscale is None:
        dst.index_copy_(0, u, quantize(new_rows, dst.dtype, key)[valid])
        return
    data, qs = quantize_rows(new_rows, key)
    dst.index_copy_(0, u, data[valid])
    qscale.index_copy_(0, u, qs[valid])


def _gather_rows(t, uids, valid, qscale=None):
    """Touched-row gather, widened to f32 after the gather (int8: decoded
    through the gathered sidecar rows)."""
    idx = torch.where(valid, uids.to(torch.int64), torch.zeros_like(uids, dtype=torch.int64))
    if qscale is None:
        return t[idx].to(torch.float32)
    return dequantize_rows(t[idx], qscale[idx])


def sparse_sgd(table, uids, g, valid, *, lr: float, weight_decay: float = 0.0,
               sr_key=None, qscale=None):
    """fbgemm EXACT_SGD parity: touched rows only, wd on touched rows.
    The table write requantizes with the raw ``sr_key``.  Returns the
    table, or ``(table, qscale)`` for an int8 table."""
    rows = _gather_rows(table, uids, valid, qscale)
    g = g.to(torch.float32) + weight_decay * rows
    _scatter_rows(table, uids, valid, rows - lr * g, sr_key, qscale)
    return table if qscale is None else (table, qscale)


def sparse_adam(table, mu, nu, count, uids, g, valid, *, lr, b1=0.9,
                b2=0.999, eps=1e-8, weight_decay=0.0, sr_key=None,
                qscale=None):
    """Row-sparse AdamW: per-row moments, global-step bias correction,
    decoupled weight decay on gathered rows only.  ``count`` is advanced in
    place.  Returns ``(table, mu, nu, count)``, ``+ (qscale,)`` for an int8
    table (its moments stay at ``slot_dtype``)."""
    rows = _gather_rows(table, uids, valid, qscale)
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
    _scatter_rows(table, uids, valid, rows - delta, component_key(sr_key, 0),
                  qscale)
    _scatter_rows(mu, uids, valid, mu_n, component_key(sr_key, 1))
    _scatter_rows(nu, uids, valid, nu_n, component_key(sr_key, 2))
    out = (table, mu, nu, count)
    return out if qscale is None else out + (qscale,)


def _row_sq_mean(g):
    """Each row's mean of squares: rowwise_adagrad's accumulator step."""
    return torch.mean(g * g, dim=-1)


def sparse_rowwise_adagrad(table, accum, uids, g, valid, *, lr, eps=1e-10,
                           weight_decay=0.0, sr_key=None, qscale=None,
                           row_sq_mean=_row_sq_mean):
    """fbgemm EXACT_ROWWISE_ADAGRAD parity: ONE f32 accumulator per row
    (mean of squared grads; never narrowed).  ``row_sq_mean(g) -> [C]``
    takes that mean over the whole row (a column shard, which holds part
    of it, passes one that gathers the rest).  ``+ (qscale,)`` for int8."""
    rows = _gather_rows(table, uids, valid, qscale)
    acc_r = _gather_rows(accum, uids, valid)
    g = g.to(torch.float32) + weight_decay * rows
    acc_n = acc_r + row_sq_mean(g)
    delta = lr * g / (torch.sqrt(acc_n)[:, None] + eps)
    _scatter_rows(table, uids, valid, rows - delta, component_key(sr_key, 0),
                  qscale)
    _scatter_rows(accum, uids, valid, acc_n)
    return (table, accum) if qscale is None else (table, accum, qscale)


def sparse_adagrad(table, accum, uids, g, valid, *, lr, eps=1e-10,
                   weight_decay=0.0, sr_key=None, qscale=None):
    """fbgemm EXACT_ADAGRAD parity (elementwise squared-grad accumulator).
    ``+ (qscale,)`` for int8."""
    rows = _gather_rows(table, uids, valid, qscale)
    acc_r = _gather_rows(accum, uids, valid)
    g = g.to(torch.float32) + weight_decay * rows
    acc_n = acc_r + g * g
    delta = lr * g / (torch.sqrt(acc_n) + eps)
    _scatter_rows(table, uids, valid, rows - delta, component_key(sr_key, 0),
                  qscale)
    _scatter_rows(accum, uids, valid, acc_n, component_key(sr_key, 1))
    return (table, accum) if qscale is None else (table, accum, qscale)


def _dense_gsum(table, ids, grads):
    """The dense lazy tier's front half: per-row summed grads ``[V, D]``
    (:func:`_segment_sum`, in input order) and the touched mask ``[V, 1]``;
    negative or out-of-range ids contribute nothing."""
    v = table.shape[0]
    ids = ids.reshape(-1).to(torch.int64)
    grads = grads.reshape(-1, grads.shape[-1]).to(torch.float32)
    ok = (ids >= 0) & (ids < v)
    gsum = _segment_sum(grads, torch.where(ok, ids, -1), v)
    touched = torch.zeros((v,), dtype=torch.bool, device=table.device)
    touched[ids[ok]] = True
    return gsum, touched[:, None]


def _masked_write(dst, touched, new, key=None):
    """``dst = where(touched, quantize(new), dst)`` in place (the whole
    block requantizes, as the reference's dense sweep)."""
    dst.copy_(torch.where(touched, quantize(new, dst.dtype, key), dst))


def dense_lazy_adam(table, mu, nu, count, ids, grads, *, lr, b1=0.9,
                    b2=0.999, eps=1e-8, weight_decay=0.0, sr_key=None):
    """Small-vocab tier: per-row summed grads (in input order) and the
    touched mask, then one dense masked sweep over the whole [V, D] table.
    Semantics equal :func:`sparse_adam`: untouched rows do not decay
    (moments, weight decay), bias correction uses the global step, and
    negative or out-of-range ids contribute nothing.  In place; returns
    ``(table, mu, nu, count)``."""
    gsum, touched = _dense_gsum(table, ids, grads)
    count += 1
    t = count.to(torch.float32)
    tf = table.to(torch.float32)
    mu_n = b1 * mu.to(torch.float32) + (1 - b1) * gsum
    nu_n = b2 * nu.to(torch.float32) + (1 - b2) * gsum * gsum
    mu_hat = mu_n / (1 - b1**t)
    nu_hat = nu_n / (1 - b2**t)
    delta = lr * (mu_hat / (torch.sqrt(nu_hat) + eps) + weight_decay * tf)
    _masked_write(table, touched, tf - delta, component_key(sr_key, 0))
    _masked_write(mu, touched, mu_n, component_key(sr_key, 1))
    _masked_write(nu, touched, nu_n, component_key(sr_key, 2))
    return table, mu, nu, count


def dense_lazy_sgd(table, ids, grads, *, lr, weight_decay=0.0, sr_key=None):
    """Scatter-free SGD for small tables; row semantics of
    :func:`sparse_sgd`.  In place; returns the table."""
    gsum, touched = _dense_gsum(table, ids, grads)
    tf = table.to(torch.float32)
    _masked_write(table, touched, tf - lr * (gsum + weight_decay * tf), sr_key)
    return table


def dense_lazy_adagrad(table, accum, ids, grads, *, lr, eps=1e-10,
                       weight_decay=0.0, sr_key=None):
    """Scatter-free EXACT_ADAGRAD for small tables; row semantics of
    :func:`sparse_adagrad`.  In place; returns ``(table, accum)``."""
    gsum, touched = _dense_gsum(table, ids, grads)
    tf = table.to(torch.float32)
    g = gsum + weight_decay * tf
    acc_n = accum.to(torch.float32) + g * g
    delta = lr * g / (torch.sqrt(acc_n) + eps)
    _masked_write(table, touched, tf - delta, component_key(sr_key, 0))
    _masked_write(accum, touched, acc_n, component_key(sr_key, 1))
    return table, accum


def dense_lazy_rowwise_adagrad(table, accum, ids, grads, *, lr, eps=1e-10,
                               weight_decay=0.0, sr_key=None):
    """Scatter-free EXACT_ROWWISE_ADAGRAD (one f32 accumulator per row) for
    small tables; row semantics of :func:`sparse_rowwise_adagrad`.  In
    place; returns ``(table, accum)``."""
    gsum, touched = _dense_gsum(table, ids, grads)
    tf = table.to(torch.float32)
    g = gsum + weight_decay * tf
    acc_n = accum + torch.mean(g * g, dim=-1)
    delta = lr * g / (torch.sqrt(acc_n)[:, None] + eps)
    _masked_write(table, touched, tf - delta, component_key(sr_key, 0))
    accum.copy_(torch.where(touched[:, 0], acc_n, accum))
    return table, accum


# ---------------------------------------------------------------------------
# the update cache (reference ``ops/sparse.py``: cache section)
# ---------------------------------------------------------------------------
#
# A cache is a dict of tensors: ``ids`` [C] sorted ascending (int32-max
# sentinels mark free entries and sort to the top), ``slot`` [C] the
# physical row each directory entry owns (a permutation of [0, C)),
# ``rows`` [C, d] at the table's storage dtype, the optimizer-state mirrors
# (``acc`` or ``mu``/``nu``), ``dirty`` / ``freq`` / ``last`` per physical
# row, the admission-overflow counter ``over``, and for int8 tables the
# ``qs`` [C, 2] sidecar mirror.  Which physical row a new id takes depends
# on the order of the free entries, which the reference leaves to an
# unstable sort; the port sorts stably.  Only the id -> value mapping is
# observable (lookups, updates and the flush go through the directory).

_CACHE_OOB = 2**31 - 1  # int32 max: free directory entry / invalid id


def cache_route(cache, ids):
    """Route ``ids`` (any shape; negatives are padding) through the
    directory: ``(phys, hit)``, the physical cache row per id (``C``, one
    past the end, where ``hit`` is False)."""
    cids = cache["ids"].to(torch.int64)
    c = cids.shape[0]
    ids = ids.to(torch.int64)
    pos = torch.searchsorted(cids, ids.reshape(-1)).reshape(ids.shape)
    posc = torch.clamp(pos, max=c - 1)
    hit = (cids[posc] == ids) & (ids >= 0) & (ids < _CACHE_OOB)
    phys = torch.where(hit, cache["slot"].to(torch.int64)[posc], c)
    return phys, hit


def cache_lookup_rows(cache, ids):
    """Route ``ids`` and gather their cached rows: ``(rows[..., d] f32,
    hit[...])``; int8 caches decode through the cached per-row grid."""
    phys, hit = cache_route(cache, ids)
    clamp = torch.clamp(phys, max=cache["rows"].shape[0] - 1)
    cur = cache["rows"][clamp]
    if "qs" in cache:
        return dequantize_rows(cur, cache["qs"][clamp]), hit
    return cur.to(torch.float32), hit


def cache_overlay_rows(cache, ids, rows):
    """Where ``ids`` hit the directory, replace ``rows`` (gathered from the
    possibly stale table) with the cache's authoritative value."""
    cur, hit = cache_lookup_rows(cache, ids)
    return torch.where(hit[..., None], cur.to(rows.dtype), rows)


def _clamped_rows(t, rows):
    """``t[rows]`` with rows past the end clamped to the last (the
    admission's local gather)."""
    return t[torch.clamp(rows, max=t.shape[0] - 1)]


def _cache_mirror_keys(kind):
    """Optimizer-slot mirror keys carried per cached row."""
    return {"sgd": (), "adagrad": ("acc",), "rowwise_adagrad": ("acc",),
            "adam": ("mu", "nu")}[kind]


def _cache_slot_index(key, kind) -> int:
    """Index of the table slot a mirror ``key`` mirrors."""
    return 0 if kind == "rowwise_adagrad" else {"acc": 0, "mu": 0, "nu": 1}[key]


def _cache_slot_mirror(key, kind, c, d, slot_dtype, device):
    """Empty ``[C]``-leading mirror of the table slot component ``key``."""
    if kind == "rowwise_adagrad":
        # ONE f32 accumulator per row (the fbgemm parity contract)
        return torch.zeros((c,), dtype=torch.float32, device=device)
    return torch.zeros((c, d), dtype=storage_dtype(slot_dtype), device=device)


def _cache_admit(cache, urows, uslot, uids, valid, kind, step, uqs=None):
    """Admit every missing valid ``uid`` (reference ``_cache_admit``): the
    k-th missing id (in id order) takes the k-th free directory entry and
    its physical row, whose value and mirrors are copied from the
    pre-gathered per-uid blocks (``urows``, ``uslot``, int8 ``uqs``: bits,
    never re-gridded); then the directory re-sorts.  Distinct ids past the
    free capacity count into ``over``; their updates are lost, so a
    non-zero count must fail the run.  Returns the new cache dict."""
    c = cache["ids"].shape[0]
    dev = urows.device
    cids, cslot = cache["ids"].to(torch.int64), cache["slot"].to(torch.int64)
    _, hit = cache_route(cache, uids)
    miss = valid & ~hit
    u = uids.to(torch.int64)
    smid, upos = torch.sort(torch.where(miss, u, _CACHE_OOB), stable=True)
    n_miss = miss.sum()
    n_used = (cids < _CACHE_OOB).sum()
    k = torch.arange(smid.shape[0], device=dev)
    dirpos = n_used + k
    admit = (k < n_miss) & (dirpos < c)
    over = ((k < n_miss) & (dirpos >= c)).sum()
    phys = cslot[torch.clamp(dirpos, max=c - 1)]
    new_ids = cids.clone()
    new_ids[dirpos[admit]] = smid[admit]
    sids, order = torch.sort(new_ids, stable=True)
    cache = dict(cache)
    cache["ids"] = sids.to(torch.int32)
    cache["slot"] = cslot[order].to(torch.int32)
    tgt, src = phys[admit], upos[admit]
    cache["rows"] = cache["rows"].index_copy(0, tgt, urows[src])
    if uqs is not None:
        cache["qs"] = cache["qs"].index_copy(0, tgt, uqs[src])
    for key in _cache_mirror_keys(kind):
        cache[key] = cache[key].index_copy(0, tgt, uslot[key][src])
    cache["dirty"] = cache["dirty"].index_fill(0, tgt, False)
    cache["freq"] = cache["freq"].index_fill(0, tgt, 0)
    cache["last"] = cache["last"].index_fill(0, tgt, int(step))
    cache["over"] = cache["over"] + over.to(torch.int32)
    return cache


def dedupe_rows_and_lines(ids: torch.Tensor, *, capacity_rows: int,
                          capacity_lines: int, rows_per_line: int,
                          with_plan: bool = False):
    """Row- AND line-level dedupe from one sort (reference
    ``dedupe_rows_and_lines``, the routed fat-line path): ``ids[B] ->
    (seg_row[B] int64, ulines[CL] int32, row_lidx[CR] int32, row_slot[CR]
    int32)``.  ``seg_row`` maps each position to its distinct-row slot;
    ``ulines`` are the distinct line ids, sorted, int32-max sentinels at the
    top; ``row_lidx`` / ``row_slot`` give each distinct row its line slot
    and its slot within the line, and unused row slots hold
    ``capacity_lines``.  Negative ids group under the sentinel line with
    slot 0.  Groups past a capacity drop, as the reference's
    ``mode="drop"`` scatters do.  Integer outputs equal the reference's.
    ``with_plan`` appends ``seg_row``'s plan for ``_segment_sum``."""
    r = rows_per_line
    ids = ids.to(torch.int64)
    clean = torch.where(ids >= 0, ids, torch.full_like(ids, SENTINEL))
    sorted_ids, order = torch.sort(clean, stable=True)
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
    out = (seg_row, ulines.to(torch.int32), row_lidx.to(torch.int32),
           row_slot.to(torch.int32))
    return out + ((order, uidx),) if with_plan else out


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


def _kernel_seed(sr_key, dtype) -> int | None:
    """Scalar int32 stochastic-rounding seed for the fat-line kernels
    (reference ``_kernel_seed``): ``randint(sr_key, (), 0, int32 max)``,
    drawn on the host; None for f32 storage or no key (round-to-nearest)."""
    if sr_key is None or storage_dtype(dtype) == torch.float32:
        return None
    return int(threefry.randint(sr_key))


def _fat_apply_rows_int8(fat, uids, g, *, layout, lr, b1=0.9, b2=0.999,
                         eps=1e-8, weight_decay=0.0, count=None,
                         sr_key=None):
    """Row-space optimizer step on int8 byte-container lines (reference
    ``_fat_apply_rows_int8``): gather the touched rows' bytes through the
    ``[L*R, W]`` view, decode (codes x sidecar -> f32 rows, state bytes ->
    exact f32), run the ``sparse_*`` math, requantize the new rows over the
    whole ``[U, d]`` uids-ordered block with the plain int8 path's key
    (raw for sgd, ``component_key(key, 0)`` otherwise), re-encode and
    write the rows back in place.  Sentinel uids clamp on the gather and
    are not written.  ``count``: adam's advanced step count."""
    d = layout.d
    view = fat_view(fat, layout)
    u = uids.to(torch.int64)
    safe = torch.clamp(u, 0, view.shape[0] - 1)
    rows_b = view[safe]  # [U, W] bytes
    rows = dequantize_rows(rows_b[:, :d], bytes_to_f32(rows_b[:, d:d + 8]))
    g = g.to(torch.float32)
    kind = layout.kind
    if kind == "sgd":
        new_rows = rows - lr * (g + weight_decay * rows)
        key_t, state_new = sr_key, ()
    elif kind == "adagrad":
        acc = bytes_to_f32(rows_b[:, d + 8:d + 8 + 4 * d])
        g2 = g + weight_decay * rows
        acc_n = acc + g2 * g2
        new_rows = rows - lr * g2 / (torch.sqrt(acc_n) + eps)
        key_t, state_new = component_key(sr_key, 0), (acc_n,)
    elif kind == "adam":
        mu = bytes_to_f32(rows_b[:, d + 8:d + 8 + 4 * d])
        nu = bytes_to_f32(rows_b[:, d + 8 + 4 * d:d + 8 + 8 * d])
        t = count.to(torch.float32)
        mu_n = b1 * mu + (1 - b1) * g
        nu_n = b2 * nu + (1 - b2) * g * g
        mu_hat = mu_n / (1 - b1**t)
        nu_hat = nu_n / (1 - b2**t)
        delta = lr * (mu_hat / (torch.sqrt(nu_hat) + eps) + weight_decay * rows)
        new_rows = rows - delta
        key_t, state_new = component_key(sr_key, 0), (mu_n, nu_n)
    else:  # rowwise_adagrad never builds an int8 layout (line_layout refuses)
        raise ValueError(kind)
    codes, qs = quantize_rows(new_rows, key_t)
    comps = [codes, f32_to_bytes(qs), *(f32_to_bytes(x) for x in state_new)]
    if layout.w > layout.need:
        comps.append(rows_b[:, layout.need:])  # the zero pad bytes
    keep = (u >= 0) & (u < view.shape[0])
    view.index_copy_(0, u[keep], torch.cat(comps, dim=1)[keep])
    return fat


def _fat_apply_int8(fat, slots, uids, g, *, layout, lr, b1, b2, eps,
                    weight_decay, sr_key=None):
    """Slot bookkeeping around :func:`_fat_apply_rows_int8` (adam's global
    step count, advanced in place, is the only state outside the line).
    Returns ``(fat, slots)``."""
    count = None
    if layout.kind == "adam":
        (count,) = slots
        count += 1
    _fat_apply_rows_int8(fat, uids, g, layout=layout, lr=lr, b1=b1, b2=b2,
                         eps=eps, weight_decay=weight_decay, count=count,
                         sr_key=sr_key)
    return fat, slots


def _fat_apply_lines(fat, slots, ulines, g_slots, touched, *, layout, lr,
                     b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                     sr_key=None):
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
              weight_decay=weight_decay,
              sr_seed=_kernel_seed(sr_key, fat.dtype))
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
               capacity: int | None = None, max_distinct: int | None = None,
               sr_key=None):
    """Big-table tier: fused in-backward optimizer over packed fat lines.
    One line-aware dedupe + one segment-sum build the kernel operands
    directly.  ``capacity``/``max_distinct`` bound distinct LINES.
    In place; returns ``(fat, slots)``."""
    layout = line_layout(embedding_dim, kind, fat.dtype)
    r = layout.r
    ids = ids.reshape(-1)
    grads = grads.reshape(-1, grads.shape[-1])
    if layout.dtype == "int8":
        # row-space dedupe (the row-sparse requantize contract): here the
        # bounds count distinct rows
        uids, g, _valid = dedupe_grads(
            ids, grads, capacity=capacity, vocab=fat.shape[0] * r,
            max_distinct=max_distinct)
        return _fat_apply_int8(
            fat, slots, uids, g, layout=layout, lr=lr, b1=b1, b2=b2,
            eps=eps, weight_decay=weight_decay, sr_key=sr_key)
    ulines, seg, _valid, plan = dedupe_ids(
        ids, capacity=capacity, vocab=fat.shape[0] * r,
        max_distinct=max_distinct, rows_per_line=r, with_plan=True)
    c = ulines.shape[0]
    g_slots = _segment_sum(grads.to(torch.float32), seg, c * r, plan)
    touched = None if r == 1 else _segment_sum(
        (ids >= 0).to(torch.float32), seg, c * r, plan)
    return _fat_apply_lines(
        fat, slots, ulines, g_slots, touched, layout=layout, lr=lr, b1=b1,
        b2=b2, eps=eps, weight_decay=weight_decay, sr_key=sr_key)


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
                     lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                     sr_key=None):
    """Fused fat-line step on pre-deduplicated row-level ``(uids, g)``
    (reference ``fat_apply_unique``): ``uids`` sorted ascending with
    int32-max sentinels at the top (the :func:`dedupe_grads` layout).  One
    :func:`fat_line_update` launch.  In place; returns ``(fat, slots)``."""
    layout = line_layout(embedding_dim, kind, fat.dtype)
    if layout.dtype == "int8":
        return _fat_apply_int8(
            fat, slots, uids, g, layout=layout, lr=lr, b1=b1, b2=b2,
            eps=eps, weight_decay=weight_decay, sr_key=sr_key)
    if valid is None:
        valid = uids < SENTINEL
    ulines, g_slots, touched = _lines_from_unique(uids, g, valid, layout)
    return _fat_apply_lines(
        fat, slots, ulines, g_slots, touched, layout=layout, lr=lr, b1=b1,
        b2=b2, eps=eps, weight_decay=weight_decay, sr_key=sr_key)


def fat_apply_routed(fat, slots, ulines, g_u, row_lidx, row_slot, lines, *,
                     embedding_dim, kind, lr, b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=0.0, sr_key=None):
    """Fused fat-line step on row-level summed grads ``g_u [CR, d]`` plus
    the routing of :func:`dedupe_rows_and_lines` (reference
    ``fat_apply_routed``): the C x R slot-space segment-sum never exists.
    ``lines [CL, T, 128]`` is the forward's gather of ``fat`` at ``ulines``
    (sentinels read line 0), at the table's storage dtype; the kernel reads
    the touched rows' state from it.  One ``fat_line_update_routed``
    launch; in place; returns ``(fat, slots)``.  int8 byte lines take
    :func:`_fat_apply_int8` on the distinct row ids rebuilt from the
    routing (in the plain path's dedupe order, so the requantize draw is
    the plain path's)."""
    layout = line_layout(embedding_dim, kind, fat.dtype)
    if layout.dtype == "int8":
        cl = ulines.shape[0]
        rl = row_lidx.to(torch.int64)
        uids = torch.where(
            rl < cl,
            ulines.to(torch.int64)[torch.clamp(rl, max=cl - 1)] * layout.r
            + row_slot.to(torch.int64),
            SENTINEL)
        return _fat_apply_int8(
            fat, slots, uids, g_u, layout=layout, lr=lr, b1=b1, b2=b2,
            eps=eps, weight_decay=weight_decay, sr_key=sr_key)
    corr = _bias_corrections(layout, slots, b1, b2, fat.device)
    fat_line_update_routed(
        fat, lines, ulines, row_lidx, row_slot, g_u.to(torch.float32), corr,
        layout=layout, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
        sr_seed=_kernel_seed(sr_key, fat.dtype))
    return fat, slots


@dataclass(frozen=True)
class SparseOptimizer:
    """``init(table) -> slots``, ``update(table, slots, ids, grads) ->
    (table, slots)`` with the reference's tier dispatch
    (``tdfo_tpu/ops/sparse.py::SparseOptimizer.update``): fat lines
    (``table.dim() == 3``, any kind) -> :func:`fat_update`; small plain adam
    tables -> :func:`dense_lazy_adam`; other plain tables -> dedupe +
    ``sparse_*``.  Every update takes the step's ``sr_key`` (None: no
    stochastic rounding)."""

    kind: str  # "sgd" | "adam" | "adagrad" | "rowwise_adagrad"
    lr: float
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    small_vocab_threshold: int = 16384
    # STORAGE dtype of the adam/adagrad slot buffers of plain tables
    # ("float32" | "bfloat16").  Fat lines pack their state at the table's
    # dtype; rowwise_adagrad's per-row accumulator stays f32 regardless.
    slot_dtype: str = "float32"

    def __post_init__(self) -> None:
        if self.kind not in ("sgd", "adam", "adagrad", "rowwise_adagrad"):
            raise ValueError(f"unknown sparse optimizer kind: {self.kind!r}")
        if self.slot_dtype not in ("float32", "bfloat16"):
            raise ValueError("slot_dtype must be 'float32' or 'bfloat16', "
                             f"got {self.slot_dtype!r}")

    def init(self, table: torch.Tensor) -> Any:
        dev = table.device
        count = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
        if table.dim() == 3:  # fat lines carry their own optimizer state
            return (count(),) if self.kind == "adam" else ()
        sd = storage_dtype(self.slot_dtype)
        if self.kind == "sgd":
            return ()
        if self.kind == "adagrad":
            return (torch.zeros_like(table, dtype=sd),)
        if self.kind == "rowwise_adagrad":
            return (torch.zeros((table.shape[0],), dtype=torch.float32,
                                device=dev),)
        return (torch.zeros_like(table, dtype=sd),
                torch.zeros_like(table, dtype=sd), count())

    def update_routed(self, table, slots, ulines, g_u, row_lidx, row_slot,
                      lines, *, embedding_dim: int, sr_key=None):
        """Fat-line routed path of the dedup-lookup step: row-level summed
        grads plus the routing of :func:`dedupe_rows_and_lines`, and the
        forward's line gather ``lines`` (:func:`fat_apply_routed`)."""
        if table.dim() != 3:
            raise ValueError("update_routed is the fat-line path")
        return fat_apply_routed(
            table, slots, ulines, g_u, row_lidx, row_slot, lines,
            embedding_dim=embedding_dim, kind=self.kind, lr=self.lr,
            b1=self.b1, b2=self.b2, eps=self.eps,
            weight_decay=self.weight_decay, sr_key=sr_key)

    def update_unique(self, table, slots, uids, g, valid, *,
                      embedding_dim: int | None = None, sr_key=None,
                      qscale=None, row_sq_mean=_row_sq_mean):
        """Tier dispatch on PRE-deduplicated ``(uids, g, valid)`` (the
        dedup-lookup step's path): fat lines take :func:`fat_apply_unique`,
        plain tables ``sparse_*`` (the small-vocab dense tier needs raw ids
        and is bypassed; ``sparse_adam`` has its semantics).  Plain int8
        tables pass their sidecar as ``qscale`` and get ``(table, slots,
        qscale)`` back; int8 fat lines carry it in-line.  ``row_sq_mean``:
        rowwise_adagrad's per-row mean of squares (a column shard's covers
        the whole row)."""
        if table.dim() == 3:
            if qscale is not None:
                raise ValueError(_INLINE_QSCALE)
            if embedding_dim is None:
                raise ValueError("fat-table update needs embedding_dim")
            return fat_apply_unique(
                table, slots, uids, g, valid, embedding_dim=embedding_dim,
                kind=self.kind, lr=self.lr, b1=self.b1, b2=self.b2,
                eps=self.eps, weight_decay=self.weight_decay, sr_key=sr_key)
        kw = dict(lr=self.lr, weight_decay=self.weight_decay, sr_key=sr_key,
                  qscale=qscale)
        tail = () if qscale is None else (qscale,)
        if self.kind == "sgd":
            sparse_sgd(table, uids, g, valid, **kw)
            return (table, slots, *tail)
        if self.kind == "adagrad":
            sparse_adagrad(table, slots[0], uids, g, valid, eps=self.eps, **kw)
            return (table, slots, *tail)
        if self.kind == "rowwise_adagrad":
            sparse_rowwise_adagrad(table, slots[0], uids, g, valid,
                                   eps=self.eps, row_sq_mean=row_sq_mean, **kw)
            return (table, slots, *tail)
        mu, nu, count = slots
        sparse_adam(table, mu, nu, count, uids, g, valid, b1=self.b1,
                    b2=self.b2, eps=self.eps, **kw)
        return (table, slots, *tail)

    def dense_update(self, table, slots, ids, grads, *, sr_key=None):
        """The dense tier for a SMALL plain table of any kind (the hot heads
        of hot/cold tables): per-row summed grads in input order and one
        masked read-modify-write of the whole ``[K, D]`` table (the
        reference's one-hot MXU contraction, summed in another order).
        Negative ids contribute nothing; untouched rows keep their state.
        In place; returns ``(table, slots)``."""
        if table.dim() != 2:
            raise ValueError(
                f"dense_update needs a plain 2D table (kind {self.kind!r}, "
                f"ndim {table.dim()})")
        kw = dict(lr=self.lr, weight_decay=self.weight_decay, sr_key=sr_key)
        if self.kind == "sgd":
            dense_lazy_sgd(table, ids, grads, **kw)
        elif self.kind == "adagrad":
            dense_lazy_adagrad(table, slots[0], ids, grads, eps=self.eps, **kw)
        elif self.kind == "rowwise_adagrad":
            dense_lazy_rowwise_adagrad(table, slots[0], ids, grads,
                                       eps=self.eps, **kw)
        else:
            mu, nu, count = slots
            dense_lazy_adam(table, mu, nu, count, ids, grads, b1=self.b1,
                            b2=self.b2, eps=self.eps, **kw)
        return table, slots

    # ------------------------------------------------------- update cache

    def cache_init(self, table, cache_rows: int) -> dict:
        """Empty update cache for a plain 2D ``table``: the sorted-id
        directory and its physical-slot permutation, value rows at the
        table's storage dtype, per-kind optimizer-slot mirrors, dirty /
        frequency / recency per row and the admission-overflow counter;
        int8 tables add the ``qs`` f32 [C, 2] grid mirror, so the flush
        stays a bit-copy."""
        if table.dim() != 2:
            raise ValueError(
                "the update cache covers plain 2D tables only (fat-line "
                "arrays keep their in-place DMA path)")
        c, d, dev = int(cache_rows), table.shape[1], table.device
        cache = {
            "ids": torch.full((c,), _CACHE_OOB, dtype=torch.int32, device=dev),
            "slot": torch.arange(c, dtype=torch.int32, device=dev),
            "rows": torch.zeros((c, d), dtype=table.dtype, device=dev),
            "dirty": torch.zeros((c,), dtype=torch.bool, device=dev),
            "freq": torch.zeros((c,), dtype=torch.int32, device=dev),
            "last": torch.zeros((c,), dtype=torch.int32, device=dev),
            "over": torch.zeros((), dtype=torch.int32, device=dev),
        }
        if table.dtype == torch.int8:
            cache["qs"] = torch.zeros((c, 2), dtype=torch.float32, device=dev)
        for key in _cache_mirror_keys(self.kind):
            cache[key] = _cache_slot_mirror(key, self.kind, c, d,
                                            self.slot_dtype, dev)
        return cache

    def cache_update_unique(self, cache, table, slots, uids, g, valid, *,
                            step, sr_key=None, qscale=None, gather=None,
                            row_sq_mean=_row_sq_mean):
        """Cached step on PRE-deduplicated ``(uids, g, valid)``: admit the
        misses (gathers of the table, its sidecar and slot rows only), then
        the ``sparse_*`` math on the cached rows and mirrors, written into
        the cache; the table and its slots are read, never written (adam's
        step count advances in place).  int8: admission copies codes and
        grid, the math decodes through the cached grid and every write
        re-grids the new rows with the plain path's block and key.
        ``gather(t, rows)``: rows of the table, its sidecar or a slot
        (clamped into the table; default a local gather; a row-sharded
        table's reads each row from its owner).  ``row_sq_mean``:
        rowwise_adagrad's per-row mean of squares (a column shard's covers
        the whole row, as :meth:`update_unique`'s).  Returns ``(cache,
        slots)``."""
        valid = valid.to(torch.bool)
        if counters.enabled():
            # pre-admission route: how many of the step's distinct rows
            # the cache held already
            _, hit = cache_route(cache, torch.where(valid, uids.to(torch.int64), -1))
            counters.emit("cache_hit_rows", (hit & valid).sum())
            counters.emit("cache_miss_rows", (valid & ~hit).sum())
        gid = torch.where(valid, uids.to(torch.int64), 0)
        take = gather or _clamped_rows
        urows = take(table, gid)
        uqs = None if qscale is None else take(qscale, gid)
        uslot = {key: take(slots[_cache_slot_index(key, self.kind)], gid)
                 for key in _cache_mirror_keys(self.kind)}
        count = slots[2] if self.kind == "adam" else None
        cache = self._cache_math(cache, uids, g, valid, urows, uslot, step,
                                 count, sr_key, uqs, row_sq_mean)
        return cache, slots

    def _cache_math(self, cache, uids, g, valid, urows, uslot, step, count,
                    sr_key, uqs=None, row_sq_mean=_row_sq_mean):
        """Admission, then the per-kind update of the cached rows (reference
        ``_cache_math``).  Returns the new cache dict."""
        cache = _cache_admit(cache, urows, uslot, uids, valid, self.kind,
                             step, uqs)
        c = cache["ids"].shape[0]
        cs, _ = cache_route(cache, uids)
        csc = torch.clamp(cs, max=c - 1)
        keep = cs < c  # the reference's mode="drop" scatters
        int8 = "qs" in cache
        if int8:
            cur = dequantize_rows(cache["rows"][csc], cache["qs"][csc])
        else:
            cur = cache["rows"][csc].to(torch.float32)
        g = g.to(torch.float32)
        lr, wd, eps = self.lr, self.weight_decay, self.eps
        tgt = cs[keep]

        def put(name, new, key=None):
            cache[name] = cache[name].index_copy(
                0, tgt, quantize(new, cache[name].dtype, key)[keep])

        def put_rows(new, key):
            # write-time requantize with the plain path's [U, d] block and
            # key, so the flush stays a bit-copy
            if int8:
                data, nqs = quantize_rows(new, key)
                cache["rows"] = cache["rows"].index_copy(0, tgt, data[keep])
                cache["qs"] = cache["qs"].index_copy(0, tgt, nqs[keep])
            else:
                put("rows", new, key)

        if self.kind == "sgd":
            put_rows(cur - lr * (g + wd * cur), sr_key)
        elif self.kind == "adagrad":
            acc_r = cache["acc"][csc].to(torch.float32)
            g2 = g + wd * cur
            acc_n = acc_r + g2 * g2
            put_rows(cur - lr * g2 / (torch.sqrt(acc_n) + eps),
                     component_key(sr_key, 0))
            put("acc", acc_n, component_key(sr_key, 1))
        elif self.kind == "rowwise_adagrad":
            acc_r = cache["acc"][csc]  # [U], always f32
            g2 = g + wd * cur
            acc_n = acc_r + row_sq_mean(g2)
            put_rows(cur - lr * g2 / (torch.sqrt(acc_n)[:, None] + eps),
                     component_key(sr_key, 0))
            put("acc", acc_n)
        else:
            mu_r = cache["mu"][csc].to(torch.float32)
            nu_r = cache["nu"][csc].to(torch.float32)
            count += 1
            t = count.to(torch.float32)
            mu_n = self.b1 * mu_r + (1 - self.b1) * g
            nu_n = self.b2 * nu_r + (1 - self.b2) * g * g
            mu_hat = mu_n / (1 - self.b1**t)
            nu_hat = nu_n / (1 - self.b2**t)
            delta = lr * (mu_hat / (torch.sqrt(nu_hat) + eps) + wd * cur)
            put_rows(cur - delta, component_key(sr_key, 0))
            put("mu", mu_n, component_key(sr_key, 1))
            put("nu", nu_n, component_key(sr_key, 2))
        cache["dirty"] = cache["dirty"].index_fill(0, tgt, True)
        cache["freq"] = cache["freq"].index_add(
            0, tgt, torch.ones_like(tgt, dtype=torch.int32))
        cache["last"] = cache["last"].index_fill(0, tgt, int(step))
        return cache

    def cache_update(self, cache, table, slots, ids, grads, *, step,
                     capacity: int | None = None,
                     max_distinct: int | None = None, sr_key=None,
                     qscale=None, gather=None, vocab_rows: int | None = None,
                     row_sq_mean=_row_sq_mean):
        """Cached analogue of :meth:`update` for plain 2D tables: the same
        :func:`dedupe_grads` (``vocab_rows``: the rows of the whole table
        when ``table`` is a shard), then :meth:`cache_update_unique`.
        Returns ``(cache, slots)``."""
        uids, g, valid = dedupe_grads(
            ids.reshape(-1), grads.reshape(-1, grads.shape[-1]),
            capacity=capacity, vocab=vocab_rows or table.shape[0],
            max_distinct=max_distinct)
        counters.emit("unique_rows", lambda: valid.sum())
        return self.cache_update_unique(cache, table, slots, uids, g, valid,
                                        step=step, sr_key=sr_key,
                                        qscale=qscale, gather=gather,
                                        row_sq_mean=row_sq_mean)

    def cache_flush(self, cache, table, slots, qscale=None, owned=None):
        """Write every dirty cached row and its mirrors back into the table
        (a bit-copy, in place), then keep the hottest ``C // 2`` entries by
        (frequency, recency, id), halve their frequencies and free the
        rest.  ``owned(rows) -> (local rows, mine)``: where a table shard
        holds each row (default: all of them, in place), so each row is
        written into its owner only.  Returns ``(cache, table, slots,
        overflow)``, with ``qscale`` before ``overflow`` for an int8 table;
        ``overflow`` is the interval's admission-overflow count, which must
        be 0."""
        c = cache["ids"].shape[0]
        cids = cache["ids"].to(torch.int64)
        cslot = cache["slot"].to(torch.int64)
        used = cids < _CACHE_OOB
        dirty_dir = cache["dirty"][cslot] & used
        counters.emit("cache_flushed_rows", lambda: dirty_dir.sum())
        counters.emit("cache_resident_rows", lambda: used.sum())
        if owned is not None:
            local, mine = owned(cids)
            dirty_dir = dirty_dir & mine
            tgt, src = local[dirty_dir], cslot[dirty_dir]
        else:
            tgt, src = cids[dirty_dir], cslot[dirty_dir]
        table.index_copy_(0, tgt, cache["rows"][src])
        if qscale is not None:
            qscale.index_copy_(0, tgt, cache["qs"][src])
        for key in _cache_mirror_keys(self.kind):
            slots[_cache_slot_index(key, self.kind)].index_copy_(
                0, tgt, cache[key][src])
        # retention: hottest first by (freq desc, recency desc, id asc);
        # evicted entries are clean after the write-back, so freeing them
        # only frees the directory entry and its physical row
        imax = _CACHE_OOB
        nf = torch.where(used, -cache["freq"].to(torch.int64)[cslot], imax)
        nl = torch.where(used, -cache["last"].to(torch.int64)[cslot], imax)
        order = torch.sort(cids, stable=True)[1]
        order = order[torch.sort(nl[order], stable=True)[1]]
        order = order[torch.sort(nf[order], stable=True)[1]]
        s_ids, s_slot = cids[order], cslot[order]
        keep = torch.arange(c, device=cids.device) < c // 2
        new_ids, o2 = torch.sort(torch.where(keep, s_ids, imax), stable=True)
        retained = torch.zeros((c,), dtype=torch.bool, device=cids.device)
        retained[s_slot[keep & (s_ids < imax)]] = True
        over = cache["over"]
        cache = dict(cache)
        cache["ids"] = new_ids.to(torch.int32)
        cache["slot"] = s_slot[o2].to(torch.int32)
        cache["dirty"] = torch.zeros_like(cache["dirty"])
        cache["freq"] = torch.where(retained, cache["freq"] // 2, 0)
        cache["last"] = torch.where(retained, cache["last"], 0)
        cache["over"] = torch.zeros_like(over)
        if qscale is not None:
            return cache, table, slots, qscale, over
        return cache, table, slots, over

    def update(self, table, slots, ids, grads, *,
               embedding_dim: int | None = None,
               capacity: int | None = None, max_distinct: int | None = None,
               sr_key=None, qscale=None, vocab_rows: int | None = None,
               row_sq_mean=_row_sq_mean):
        """One row-sparse step on ``table`` (in place): fat lines through
        :func:`fat_update`, small plain adam tables (``vocab_rows``, the
        global rows of a sharded table, else its own, at most
        ``small_vocab_threshold``) through the dense tier, the rest through
        :func:`dedupe_grads` and :meth:`update_unique` (``row_sq_mean``:
        see there)."""
        rows = table.shape[0] if vocab_rows is None else vocab_rows
        if table.dim() == 3:
            if qscale is not None:
                raise ValueError(_INLINE_QSCALE)
            if embedding_dim is None:
                raise ValueError("fat-table update needs embedding_dim")
            return fat_update(
                table, slots, ids, grads, embedding_dim=embedding_dim,
                kind=self.kind, lr=self.lr, b1=self.b1, b2=self.b2,
                eps=self.eps, weight_decay=self.weight_decay,
                capacity=capacity, max_distinct=max_distinct, sr_key=sr_key)
        if (self.kind == "adam" and qscale is None
                and rows <= self.small_vocab_threshold):
            # the dense sweep's full-block requantize would re-grid every
            # untouched int8 row, so int8 tables stay on the row path
            mu, nu, count = slots
            table, mu, nu, count = dense_lazy_adam(
                table, mu, nu, count, ids, grads, lr=self.lr, b1=self.b1,
                b2=self.b2, eps=self.eps, weight_decay=self.weight_decay,
                sr_key=sr_key)
            return table, (mu, nu, count)
        uids, g, valid = dedupe_grads(
            ids.reshape(-1), grads.reshape(-1, grads.shape[-1]),
            capacity=capacity, vocab=table.shape[0], max_distinct=max_distinct)
        return self.update_unique(table, slots, uids, g, valid,
                                  embedding_dim=embedding_dim, sr_key=sr_key,
                                  qscale=qscale, row_sq_mean=row_sq_mean)


_INLINE_QSCALE = ("fat-line int8 tables carry their (scale, offset) sidecar "
                  "in-line — qscale is only for plain 2D int8 tables")


def sparse_optimizer(kind: str, lr: float, weight_decay: float = 0.0,
                     **kw) -> SparseOptimizer:
    return SparseOptimizer(kind=kind, lr=lr, weight_decay=weight_decay, **kw)
