"""ShardedEmbeddingCollection — single-device port of
``tdfo_tpu/parallel/embedding.py``.

Tables are plain tensors in a dict (name -> tensor), exactly the reference's
``init()`` pytree: plain tables are ``[V, d]``; fused tables (vocab above
``fused_threshold``) live as packed fat lines ``[L, T, 128]``
(``ops/fat_lines.py``) and all fused tables sharing ``(d, sharding)`` are
STACKED into one ``__fatstack_{d}_{sharding}`` array, so the whole group
costs one dedupe and one fat-line kernel launch per step (fbgemm's
table-batched embedding design).  With ``stack_tables=True`` the plain
tables sharing ``(d, sharding)`` stack the same way into one
``__tablestack_{d}_{sharding}_float32`` ``[V, d]`` array.  Array names and
row offsets equal the reference's, so tables move between the packages as
arrays.

Storage dtype is a property of the spec (``float32``, ``bfloat16`` or
``int8``): ``init`` draws in f32 and stores narrow (round-to-nearest),
lookups widen to f32 after the gather, and tables of different dtypes
never share a stack (narrow stacks carry the dtype suffix, e.g.
``__fatstack_{d}_{sharding}_bfloat16``, ``__tablestack_{d}_{sharding}_int8``).
A plain int8 array keeps its f32 ``[V, 2]`` (scale, offset) sidecar in the
tables dict under ``qscale_name(array)`` (``__qscale__/`` + the name); a
fused int8 array packs it in each line (``ops/fat_lines.py``).

Hot/cold tables (``hot_ids=``): each listed plain table also gets a hot
head ``{name}__hot`` ``[K, d]``, gathered at init from the table's own
rows (decoded to f32 for int8), and ids route per position to the head or to
the unchanged cold array (:meth:`ShardedEmbeddingCollection.route_ids`: a
compare for a ``[0, K)`` prefix, ``torch.searchsorted`` otherwise).  The
update cache (``cache_rows=``) covers the plain arrays that take
row-sparse updates (:meth:`~ShardedEmbeddingCollection.cached_array_names`);
its state rides in the train state's slots under ``CACHE_PREFIX``.

Ported: ``make_embedding_specs``, ``EmbeddingSpec`` and, on the
collection, ``init``, ``init_caches``, ``features``, ``resolve``,
``resolve_table``, ``route_ids`` and the hot-set members, ``fat_layout``,
``fat_layout_for``, ``array_embedding_dim``, ``array_is_int8``,
``lookup(mode="gspmd")`` and ``sparse_update``.  Not ported yet: meshes,
column/table sharding, the psum/alltoall lookups and the grouped exchange
(``ROADMAP.md`` Queue A item 12).  Refused, not ignored.  As in the
reference, bf16 and int8 fused tables under ``rowwise_adagrad`` refuse:
a fat line holds the table and its optimizer state together, and the
per-row accumulator is f32 by contract.

``init`` draws from a ``torch.Generator`` (the reference uses
``jax.random``, so same-seed tables differ between the packages; the
parity tests inject the reference's tables through ``interop``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from tdfo_tpu_torch.core.device import resolve_device
from tdfo_tpu_torch.ops.fat_lines import (
    _dtype_name,
    fat_gather_rows,
    fat_pack,
    line_layout,
)
from tdfo_tpu_torch.ops.quant import dequantize_rows, quantize_rows, storage_dtype

__all__ = ["CACHE_PREFIX", "EmbeddingSpec", "QSCALE_PREFIX",
           "ShardedEmbeddingCollection", "embedding_lookup",
           "make_embedding_specs", "qscale_name", "take_fill"]

# slots key prefix of a cached array's update cache
# (``SparseOptimizer.cache_init``): the caches ride in the train state's
# slots, so a cache-off state keeps its structure
CACHE_PREFIX = "__cache__/"

# tables key prefix of a plain int8 array's f32 [V, 2] (scale, offset)
# sidecar (column 0 = scale, column 1 = offset, ``ops/quant.py``)
QSCALE_PREFIX = "__qscale__/"


def qscale_name(array_name: str) -> str:
    """Tables-dict key of ``array_name``'s int8 (scale, offset) sidecar."""
    return QSCALE_PREFIX + array_name


def _spec_is_int8(spec: "EmbeddingSpec") -> bool:
    return storage_dtype(spec.dtype) == torch.int8


def take_fill(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)`` under jax's default ``mode="fill"``:
    ids in ``[-V, V)`` index numpy-style (negatives wrap), any other id
    reads a row of NaN.  ``ids`` any shape; the output gains the table's
    trailing axes (a row of a plain table, a whole line of a fat one)."""
    v = table.shape[0]
    ids = ids.to(torch.int64)
    ids = torch.where(ids < 0, ids + v, ids)
    inside = (ids >= 0) & (ids < v)
    rows = table[torch.where(inside, ids, 0)]
    inside = inside.reshape(inside.shape + (1,) * (table.dim() - 1))
    return torch.where(inside, rows, float("nan"))


class _TakeFill(torch.autograd.Function):
    """:func:`take_fill` whose gradient is a row-wise ``index_add_`` (ids
    outside the table get none, as under ``jnp.take``'s fill mode)."""

    @staticmethod
    def forward(ctx, table, ids):
        v = table.shape[0]
        ids = ids.to(torch.int64)
        rows = torch.where(ids < 0, ids + v, ids)
        inside = (rows >= 0) & (rows < v)
        ctx.save_for_backward(torch.where(inside, rows, 0), inside)
        ctx.num_rows = v
        return take_fill(table, ids)

    @staticmethod
    def backward(ctx, grad):
        rows, inside = ctx.saved_tensors
        g = torch.where(inside[..., None], grad, 0.0).reshape(-1, grad.shape[-1])
        out = torch.zeros((ctx.num_rows, grad.shape[-1]), dtype=grad.dtype,
                          device=grad.device)
        return out.index_add_(0, rows.reshape(-1), g), None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Embed`` on a plain ``[V, d]`` parameter: :func:`take_fill`'s
    rows (a one-row table broadcasts, as flax does), differentiable with
    respect to ``table`` without a host sync, so a step built on it can be
    captured in a CUDA graph."""
    if table.shape[0] == 1:
        return table.expand(*ids.shape, table.shape[1])
    return _TakeFill.apply(table, ids)


def make_embedding_specs(size_map, entries, embed_dim: int,
                         sharding: str = "row",
                         fused_threshold: int | None = 16384):
    """One table per ``(size_map key, table name, input column)`` entry:
    glorot-bound uniform init ``sqrt(6 / (V + D))``, fat-line fused storage
    above ``fused_threshold`` rows (``None`` disables)."""
    specs = []
    for key, name, column in entries:
        vocab = int(size_map[key])
        specs.append(EmbeddingSpec(
            name=name,
            num_embeddings=vocab,
            embedding_dim=embed_dim,
            features=(column,),
            sharding=sharding,
            init_scale=math.sqrt(6.0 / (vocab + embed_dim)),
            fused=(fused_threshold is not None
                   and sharding in ("row", "replicated")
                   and vocab > fused_threshold),
        ))
    return specs


@dataclass(frozen=True)
class EmbeddingSpec:
    """torchrec ``EmbeddingConfig`` parity (reference ``EmbeddingSpec``)."""

    name: str
    num_embeddings: int
    embedding_dim: int
    features: tuple[str, ...] = ()
    sharding: str = "row"
    init_scale: float = 1.0
    dtype: torch.dtype = torch.float32
    fused: bool = False

    def feature_names(self) -> tuple[str, ...]:
        return self.features or (self.name,)


class ShardedEmbeddingCollection:
    """A set of embedding tables and their lookup, on one device.

    ``init`` returns the table dict; ``lookup`` maps feature ids to vectors
    (a gather, no autograd link to the tables); ``sparse_update`` applies the
    row-sparse optimizer to one array in place."""

    def __init__(self, specs: list[EmbeddingSpec], *, fused_kind: str = "adam",
                 stack_tables: bool = False,
                 hot_ids: Mapping[str, np.ndarray] | None = None,
                 cache_rows: int = 0):
        """``hot_ids``: table or feature name -> that table's sorted hot ids
        (the frequency-partitioned mode); ``cache_rows``: rows of the
        update cache of every row-sparse plain array (0: off)."""
        line_layout(1, fused_kind)  # validates the kind eagerly
        if cache_rows < 0:
            raise ValueError("cache_rows must be >= 0")
        self.cache_rows = cache_rows
        self.fused_kind = fused_kind
        self.specs = {s.name: s for s in specs}
        if len(self.specs) != len(specs):
            raise ValueError("duplicate table names")
        self._feature_to_table: dict[str, str] = {}
        for s in specs:
            if s.sharding not in ("row", "replicated"):
                raise NotImplementedError(
                    f"table {s.name!r}: {s.sharding!r} sharding is not ported "
                    "yet (ROADMAP.md Queue A item 12)")
            dt = storage_dtype(s.dtype)  # float32, bfloat16 or int8
            if (s.fused and dt == torch.bfloat16
                    and fused_kind == "rowwise_adagrad"):
                # fat lines pack table AND state at one dtype; the rowwise
                # accumulator is contractually f32 per row (fbgemm
                # EXACT_ROWWISE_ADAGRAD), so it cannot ride a bf16 line
                raise ValueError(
                    f"table {s.name!r}: fused rowwise_adagrad storage "
                    "cannot be bfloat16 (the per-row accumulator is f32 by "
                    "the fbgemm parity contract)")
            if (s.fused and dt == torch.int8
                    and fused_kind == "rowwise_adagrad"):
                raise ValueError(
                    f"table {s.name!r}: fused int8 storage does not support "
                    "rowwise_adagrad (the f32 per-row accumulator contract "
                    "cannot ride a quantized line)")
            for f in s.feature_names():
                if f in self._feature_to_table:
                    raise ValueError(f"feature {f!r} served by two tables")
                self._feature_to_table[f] = s.name
        # table stacks: fused tables sharing (dim, sharding, dtype) -> one
        # fat array, and with stack_tables the plain ones -> one [V, d]
        # array; _stacks maps the array name to (sharding, dim, members,
        # fused)
        self._stack_rows: dict[str, tuple[int, int]] = {}
        self._stacks: dict[str, tuple[str, int, list[EmbeddingSpec], bool]] = {}
        self._member_to_stack: dict[str, str] = {}

        def build_stacks(members, fused: bool):
            by_key: dict[tuple, list[EmbeddingSpec]] = {}
            for s in members:
                # f32 fat stacks keep the un-suffixed name; plain and bf16
                # fat stacks carry the dtype name (reference build_stacks)
                name = _dtype_name(s.dtype)
                dt = "" if fused and name == "float32" else name
                by_key.setdefault((s.embedding_dim, s.sharding, dt), []).append(s)
            prefix = "__fatstack_" if fused else "__tablestack_"
            for (dim, shard_kind, dt), group in sorted(
                    by_key.items(), key=lambda kv: str(kv[0])):
                if len(group) < 2:
                    continue  # single tables keep their own array (and name)
                gname = (f"{prefix}{dim}_{shard_kind}" if fused and not dt
                         else f"{prefix}{dim}_{shard_kind}_{dt}")
                total = sum(s.num_embeddings for s in group)
                unit = self.fat_layout(dim, group[0].dtype).r if fused else 1
                total = -(-total // unit) * unit
                off = 0
                for s in group:
                    self._stack_rows[s.name] = (off, total)
                    self._member_to_stack[s.name] = gname
                    off += s.num_embeddings
                self._stacks[gname] = (shard_kind, dim, group, fused)

        build_stacks([s for s in specs if s.fused], fused=True)
        if stack_tables:
            build_stacks([s for s in specs if not s.fused], fused=False)

        # hot/cold split: table name -> sorted hot ids, and whether the set
        # is the [0, K) prefix (one compare) or the whole vocab (no cold
        # side at all)
        self.hot_ids: dict[str, np.ndarray] = {}
        self._hot_prefix: dict[str, bool] = {}
        self._hot_full: dict[str, bool] = {}
        self._hot_dev: dict[tuple[str, str], torch.Tensor] = {}
        for key, ids in (hot_ids or {}).items():
            tname = self._feature_to_table.get(key, key)
            spec = self.specs.get(tname)
            if spec is None:
                raise KeyError(
                    f"hot_ids key {key!r} names neither a table nor a feature")
            arr = np.asarray(ids, dtype=np.int32)
            if arr.ndim != 1 or arr.size == 0 or (
                    arr.size > 1 and np.any(np.diff(arr) <= 0)):
                raise ValueError(
                    f"table {tname!r}: hot ids must be a non-empty sorted "
                    "unique 1D array")
            if arr[0] < 0 or arr[-1] >= spec.num_embeddings:
                raise ValueError(
                    f"table {tname!r}: hot ids outside [0, "
                    f"{spec.num_embeddings})")
            if spec.fused or spec.sharding not in ("row", "replicated"):
                raise ValueError(
                    f"table {tname!r}: hot/cold supports plain (non-fused) "
                    f"row/replicated tables; got fused={spec.fused}, "
                    f"sharding={spec.sharding!r}")
            if tname in self.hot_ids:
                raise ValueError(f"table {tname!r} given two hot-id sets")
            if self.hot_array_name(tname) in self.specs:
                raise ValueError(
                    f"table name {self.hot_array_name(tname)!r} collides "
                    f"with the hot head array of {tname!r}")
            self.hot_ids[tname] = arr
            k = int(arr.shape[0])
            self._hot_prefix[tname] = bool(arr[-1] == k - 1)  # == arange(k)
            self._hot_full[tname] = k == spec.num_embeddings

    # ----------------------------------------------------------- hot/cold

    @staticmethod
    def hot_array_name(tname: str) -> str:
        """Tables-dict key of a hot table's head array."""
        return f"{tname}__hot"

    def hot_tables(self) -> tuple[str, ...]:
        """Logical table names with a hot/cold split (sorted)."""
        return tuple(sorted(self.hot_ids))

    def hot_count(self, tname: str) -> int:
        """Hot-head rows of ``tname`` (0 when the table is not split)."""
        ids = self.hot_ids.get(tname)
        return 0 if ids is None else int(ids.shape[0])

    def hot_full(self, tname: str) -> bool:
        """True when every id of ``tname`` is hot: the cold side is dead
        storage, never gathered or updated."""
        return self._hot_full.get(tname, False)

    def hot_digest(self) -> dict[str, str]:
        """Per-table hot-set fingerprints for the checkpoint stamps (empty
        when no table is split)."""
        from tdfo_tpu_torch.data.hot_ids import hot_ids_digest

        return hot_ids_digest(self.hot_ids) if self.hot_ids else {}

    def route_ids(self, feature: str, ids: torch.Tensor):
        """Split a feature's ids into ``(hot_pos, cold_ids)``: ``hot_pos`` is
        the id's row in the hot head (-1 for cold or padding ids),
        ``cold_ids`` the id with hot hits replaced by -1 (padding for every
        later stage).  ``(None, ids)`` for an unsplit table.  A ``[0, K)``
        prefix routes with one compare, any other set with one
        ``torch.searchsorted`` against the sorted hot ids."""
        tname = self._feature_to_table.get(feature, feature)
        hids = self.hot_ids.get(tname)
        if hids is None:
            return None, ids
        k = hids.shape[0]
        neg = ids < 0
        if self._hot_full[tname]:
            return torch.where(neg, -1, ids), torch.full_like(ids, -1)
        if self._hot_prefix[tname]:
            hit = ~neg & (ids < k)
            hot_pos = torch.where(hit, ids, -1)
        else:
            key = (tname, str(ids.device))
            if key not in self._hot_dev:
                self._hot_dev[key] = torch.from_numpy(hids.astype(np.int64)).to(
                    ids.device)
            sorted_hot = self._hot_dev[key]
            i64 = ids.to(torch.int64)
            pos = torch.clamp(torch.searchsorted(sorted_hot, i64.reshape(-1)),
                              0, k - 1).reshape(ids.shape)
            hit = ~neg & (sorted_hot[pos] == i64)
            hot_pos = torch.where(hit, pos.to(ids.dtype), -1)
        return hot_pos, torch.where(hit, -1, ids)

    # ---------------------------------------------------------------- init

    def fat_layout(self, d: int, dtype=torch.float32):
        """Packed-line geometry of fused storage at embedding dim ``d`` and
        storage ``dtype`` under this collection's ``fused_kind``."""
        return line_layout(d, self.fused_kind, dtype)

    def _array_spec(self, array_name: str) -> EmbeddingSpec:
        """A spec of the array (a stack's members share dim and dtype)."""
        if array_name in self._stacks:
            return self._stacks[array_name][2][0]
        return self.specs[array_name]

    def fat_layout_for(self, array_name: str):
        spec = self._array_spec(array_name)
        return self.fat_layout(spec.embedding_dim, spec.dtype)

    def init(self, seed: int = 0, *, device="cuda") -> dict[str, torch.Tensor]:
        """Create all tables on ``device`` (default the card; ``"cpu"`` must
        be asked for).  Uniform(-init_scale, init_scale) per table from a
        ``torch.Generator`` seeded with ``seed``, drawn in f32 and stored at
        the spec's dtype; optimizer state in fat lines starts at zero; stack
        padding rows are zero."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(int(seed))

        def draw(spec, rows):
            t = torch.rand((rows, spec.embedding_dim), generator=gen,
                           device=device, dtype=torch.float32)
            return t.mul_(2 * spec.init_scale).sub_(spec.init_scale)

        tables: dict[str, torch.Tensor] = {}

        def place(name, t, spec, fused):
            # fat lines pack (int8: quantized in the line, sidecar in-line);
            # plain int8 rounds to nearest onto the rowwise grid and keeps
            # its sidecar under __qscale__/
            if fused:
                tables[name] = fat_pack(t, kind=self.fused_kind,
                                        layout=self.fat_layout_for(name))
            elif _spec_is_int8(spec):
                tables[name], tables[qscale_name(name)] = quantize_rows(t)
            else:
                tables[name] = t.to(spec.dtype)

        for name, spec in self.specs.items():
            if name in self._member_to_stack:
                continue
            lay = self.fat_layout(spec.embedding_dim, spec.dtype)
            unit = lay.r if spec.fused else 1
            rows = -(-spec.num_embeddings // unit) * unit
            place(name, draw(spec, rows), spec, spec.fused)
        for gname, (_, dim, group, fused) in self._stacks.items():
            total = self._stack_rows[group[0].name][1]
            t = torch.zeros((total, dim), dtype=torch.float32, device=device)
            for s in group:
                off, _ = self._stack_rows[s.name]
                t[off:off + s.num_embeddings] = draw(s, s.num_embeddings)
            place(gname, t, group[0], fused)
            del t
        # hot heads: a gather of the initialised cold rows (at the table's
        # dtype; int8 decodes to an f32 head), so a hot/cold run starts
        # from the unsplit run's tables; the cold copies of hot rows are
        # never read or updated again
        for tname in sorted(self.hot_ids):
            aname, _, off = self.resolve_table(tname)
            idx = torch.from_numpy(self.hot_ids[tname].astype(np.int64) + off
                                   ).to(device)
            hot = tables[aname][idx]
            if self.array_is_int8(aname):
                hot = dequantize_rows(hot, tables[qscale_name(aname)][idx])
            tables[self.hot_array_name(tname)] = hot
        return tables

    # -------------------------------------------------------- update cache

    def cached_array_names(self, opt, tables) -> tuple[str, ...]:
        """Array names the update cache covers (sorted): plain 2D arrays
        that take row-sparse updates.  Not fat arrays, hot heads, the cold
        arrays of fully hot tables (never updated) or small-vocab f32/bf16
        adam arrays (the dense tier; int8 ones stay row-sparse and are
        cached)."""
        if self.cache_rows <= 0:
            return ()
        hot_heads = {self.hot_array_name(t) for t in self.hot_ids}
        updated = {self.resolve_table(t)[0] for t in self.specs
                   if not self._hot_full.get(t, False)}
        out = []
        for aname in sorted(updated):
            t = tables[aname]
            if t.dim() != 2 or aname in hot_heads:
                continue
            if (opt.kind == "adam" and t.shape[0] <= opt.small_vocab_threshold
                    and not self.array_is_int8(aname)):
                continue
            out.append(aname)
        return tuple(out)

    def init_caches(self, tables, opt) -> dict[str, dict]:
        """Empty update caches for every cached array, keyed
        ``CACHE_PREFIX + array name`` (the trainer merges them into the
        slots, so checkpoints and rollback snapshots carry them)."""
        return {CACHE_PREFIX + a: opt.cache_init(tables[a], self.cache_rows)
                for a in self.cached_array_names(opt, tables)}

    # -------------------------------------------------------------- lookup

    def features(self) -> tuple[str, ...]:
        """All feature names served by this collection."""
        return tuple(self._feature_to_table)

    def resolve(self, feature: str) -> tuple[str, EmbeddingSpec, int]:
        """Map a feature name to ``(array_name, spec, row_offset)``."""
        tname = self._feature_to_table.get(feature)
        if tname is None:
            raise KeyError(f"no table serves feature {feature!r}")
        return self.resolve_table(tname)

    def resolve_table(self, tname: str) -> tuple[str, EmbeddingSpec, int]:
        """:meth:`resolve` keyed by logical TABLE name instead of feature."""
        spec = self.specs[tname]
        gname = self._member_to_stack.get(tname)
        if gname is not None:
            return gname, spec, self._stack_rows[tname][0]
        return tname, spec, 0

    def array_embedding_dim(self, array_name: str) -> int:
        if array_name in self._stacks:
            return self._stacks[array_name][1]
        return self.specs[array_name].embedding_dim

    def array_is_int8(self, array_name: str) -> bool:
        """True when an array stores int8 codes (a plain one keeps its f32
        sidecar at ``qscale_name(array_name)``)."""
        return _spec_is_int8(self._array_spec(array_name))

    def lookup(self, tables, features, mode: str = "gspmd"):
        """ids -> f32 vectors for every feature (ids any shape; the output
        gains a trailing ``embedding_dim`` axis).  Out-of-range ids read
        what the reference's ``jnp.take`` (jax's default ``mode="fill"``)
        reads: see :func:`take_fill` and ``fat_gather_rows``."""
        if mode != "gspmd":
            raise NotImplementedError(
                f"lookup mode {mode!r} is not ported yet (ROADMAP.md Queue A "
                "item 12)")
        out: dict[str, torch.Tensor] = {}
        for feat, ids in features.items():
            if self._feature_to_table.get(feat) in self.hot_ids:
                out[feat] = self._lookup_hotcold(tables, feat, ids)
                continue
            aname, spec, offset = self.resolve(feat)
            gid = ids.to(torch.int64) + offset
            out[feat] = self._gather(tables, aname, spec, gid)
        return out

    def _gather(self, tables, aname, spec, gid):
        """Rows ``gid`` of array ``aname``, f32: fat lines slot-select (int8
        decodes in the gather), plain int8 decodes through the gathered
        sidecar rows (an id outside the table reads NaN, as the
        reference's fill-mode gather of the sidecar does)."""
        table = tables[aname]
        if spec.fused:
            return fat_gather_rows(table, gid, self.fat_layout_for(aname))
        if _spec_is_int8(spec):
            v = table.shape[0]
            idx = torch.where(gid < 0, gid + v, gid).clamp(0, v - 1)
            return dequantize_rows(table[idx],
                                   take_fill(tables[qscale_name(aname)], gid))
        return take_fill(table, gid).to(torch.float32)  # widen after the gather

    def _lookup_hotcold(self, tables, feat: str, ids: torch.Tensor):
        """Routed lookup of a hot/cold table: the head's row at hot hits,
        the cold array's elsewhere (a fully hot table has no cold side:
        padding ids read head row 0)."""
        tname = self._feature_to_table[feat]
        hot_pos, cold_ids = self.route_ids(feat, ids)
        hot = tables[self.hot_array_name(tname)]
        hot_vec = hot[torch.clamp(hot_pos.to(torch.int64), min=0)]
        if self._hot_full[tname]:
            return hot_vec
        aname, spec, offset = self.resolve(feat)
        cidx = torch.where(cold_ids >= 0, cold_ids.to(torch.int64) + offset, 0)
        cold_vec = self._gather(tables, aname, spec, cidx)
        return torch.where((hot_pos >= 0)[..., None], hot_vec.to(cold_vec.dtype),
                           cold_vec)

    # -------------------------------------------------------------- update

    def sparse_update(self, opt, array_name: str, table, slots, ids, grads,
                      max_distinct: int | None = None, sr_key=None,
                      qscale=None):
        """Apply the row-sparse optimizer to one array (in place; returns
        ``(table, slots)``, ``+ (qscale,)`` for a plain int8 array).  On one
        device every array takes ``opt.update`` directly (the reference's
        shard_map branch serves row-sharded fat tables on a real model
        axis)."""
        d = self.array_embedding_dim(array_name)
        return opt.update(table, slots, ids, grads, embedding_dim=d,
                          capacity=max_distinct, max_distinct=max_distinct,
                          sr_key=sr_key, qscale=qscale)
