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

Sharding (``mesh=``, a ``DeviceMesh`` from ``core/mesh.py``; the tables
shard over its ``model`` axis, M ranks, and replicate over ``data``): each
rank's tables dict holds its own shard.

* ``row``: the vocab is padded to M x R rows (fat stacks to whole lines
  per shard) and rank k holds rows ``[k R, (k+1) R)``;
* ``table``: tables sharing a dim stack into ``__stack_{dim}``, slot i of M
  holding tables i, i+M, ...; each shard's rows cover whole tables;
* ``column``: every rank holds all rows and ``d / M`` columns;
* ``replicated``: every rank holds the whole table.

``init`` draws the global tables exactly as the single-device ``init``
with the same seed does (each table whole, from one generator stream) and
keeps each rank's rows or columns, so a sharded run can be held to a
single-device one from one seed.  Lookups (:meth:`lookup`): ``psum`` (a
masked local gather, then a sum over the model axis), ``alltoall`` (ids
bucketed by owner, ``all_to_all_single`` out and back, capacity
``a2a_capacity_factor``; the ids are this rank's share of the batch), and
``gspmd``, which on a sharded table runs the psum program with ``jnp.take``'s
fill rule on the global padded table (the port has no partitioner; the
results are the reference's).  Column tables gather their columns and
all-gather them.  :meth:`sparse_update` takes the global batch's ids and
grads: row-sharded arrays (fat ones through the ``fat_line_update``
kernel on the local lines) keep the ids they own, rebased by ``k R``,
foreign ids becoming -1 with zero grads; narrow storage folds the
stochastic-rounding key with k.  Column shards update their columns.

int8 under a mesh: a plain int8 array's ``[V, 2]`` sidecar shards with its
rows (a replicated array's replicates), fused int8 lines carry theirs in
the line; the psum and alltoall programs decode at the owner, and each
rank's update requantizes its own rows.  Column sharding refuses int8, as
in the reference (the grid is per whole row).

The grouped exchange (``grouped_a2a``, torchrec's grouped KJTAllToAll
input-dist): under ``alltoall`` every row- and table-sharded feature of
one ``(embedding_dim, storage dtype)`` group rides ONE offset-shifted
virtual id stream (:class:`_A2AGroup`): one stable owner sort and one id
``all_to_all`` out (:meth:`grouped_input_dist`, which reads no table), one
vector ``all_to_all`` back at the storage dtype (int8 codes with their f32
``(scale, offset)`` rows in a second, small exchange; decoded to f32 after
it, :meth:`grouped_lookup`), and one id plus one grad ``all_to_all`` for
the update (:meth:`grouped_update`): O(1) collectives per direction, not
O(tables).  Replicated tables take the per-feature path beside it.

A seq axis (Bert4Rec's ring) replicates everything here: each seq
replica holds the tables as a mesh without it would and updates its own
copy identically, one ``fat_line_update`` a step on each rank's shard.

Hot heads and update caches under a mesh are replicated: every rank
holds the same ones (the reference pins them ``P()``).  ``init`` gathers
each head from the cold rows it replaces, each row from the rank that owns
it (:meth:`owner_gather`: the owner's bits, the other ranks adding -0.0,
the identity of IEEE addition); the cold side of a hot/cold lookup runs
the ``gspmd`` program.  The cache's admission reads a row-sharded table
the same way, and its flush writes each row into its owner only
(:meth:`owned_rows`).  A column shard under ``rowwise_adagrad`` keeps the
whole ``[V]`` accumulator, the same on every rank: its update all-gathers
the ``[C, d / M]`` grad blocks and takes each row's mean of squares over
the whole row, as one device does.  Over a column-sharded table the cache's
directory (ids, slots, dirty bits, frequencies) is replicated, and its
value rows and elementwise mirrors hold this rank's columns ``[C, d / M]``,
so its memory falls with M as the table's does; rowwise_adagrad's cached
accumulator is the whole-row mean, the same on every rank.  As in the
reference, bf16 and int8 fused tables under
``rowwise_adagrad`` refuse: a fat line holds the table and its optimizer
state together, and the per-row accumulator is f32 by contract.

``init`` draws from a ``torch.Generator`` (the reference uses
``jax.random``, so same-seed tables differ between the packages; the
parity tests inject the reference's tables through ``interop``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch

from tdfo_tpu_torch.core.device import resolve_device
from tdfo_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    axis_group,
    axis_index,
    axis_size,
)
from tdfo_tpu_torch.ops.fat_lines import (
    _dtype_name,
    fat_gather_rows,
    fat_pack,
    line_layout,
)
from tdfo_tpu_torch.ops.kernels.fat_line_update import SENTINEL
from tdfo_tpu_torch.ops.kernels.segment_sum import segment_sum
from tdfo_tpu_torch.ops import threefry
from tdfo_tpu_torch.ops.quant import (
    dequantize_rows,
    quantize_rows,
    storage_dtype,
    table_id,
)
from tdfo_tpu_torch.parallel.collectives import (
    AllReduceSum,
    AllToAll,
    SeqGather,
    all_gather_cat,
    all_reduce_,
    all_to_all,
    gather_to_host,
)

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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _a2a_bucket_cap(n: int, m: int, cf: float | None) -> int:
    """Per-owner send-bucket capacity of the alltoall lookup for a local
    batch of ``n`` ids over ``m`` shards under capacity factor ``cf``
    (``None``: the exact worst case ``n``); bounded buckets round up to a
    multiple of 8, never past ``n`` (reference ``_a2a_bucket_cap``, shared
    by the lookup and :meth:`ShardedEmbeddingCollection.a2a_overflow`)."""
    cap = n if cf is None else min(n, max(1, int(cf * n / m)))
    if cap < n:
        cap = min(n, -(-cap // 8) * 8)
    return cap


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
    """:func:`take_fill` whose gradient is a row-wise segment sum in input
    order (``ops/kernels/segment_sum.py``; ids outside the table get none,
    as under ``jnp.take``'s fill mode)."""

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
        seg = torch.where(inside, rows, -1).reshape(-1)
        return segment_sum(grad.reshape(-1, grad.shape[-1]), seg,
                           ctx.num_rows), None


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


@dataclass(frozen=True)
class _A2AGroup:
    """Static plan of one grouped exchange (reference ``_A2AGroup``): the
    features whose tables share ``(embedding_dim, storage dtype)`` ride one
    virtual id stream.  Each array's ``rows_per_shard`` (from the specs,
    never the live tables, so the id exchange reads no table) and
    cumulative ``bases`` give disjoint per-shard virtual ranges: id ``i``
    of array ``a`` goes to owner ``i // rps_a`` as virtual id ``i - owner
    rps_a + base_a``, which the owner decodes by base range."""

    key: str                                # "{dim}_{dtype}"
    dim: int
    feats: tuple[str, ...]                  # input order = stream order
    feat_meta: tuple[tuple[int, int], ...]  # per feature: (array idx, row offset)
    arrays: tuple[str, ...]
    specs: tuple[EmbeddingSpec, ...]        # a spec of each array
    rows_per_shard: tuple[int, ...]
    bases: tuple[int, ...]


@dataclass
class _Dist:
    """One group's input-dist: the received virtual ids ``recv [M cap]``
    and the unpermute map ``slot_inv [n]`` (-1: dropped past a full
    bucket); ``work`` is the id exchange's handle while it is in flight,
    ``send`` its buffer, held until :meth:`wait`."""

    recv: torch.Tensor
    slot_inv: torch.Tensor
    work: Any = None
    send: torch.Tensor | None = None

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
            self.work, self.send = None, None
        return self.recv


class ShardedEmbeddingCollection:
    """A set of embedding tables and their lookup, on one device.

    ``init`` returns the table dict; ``lookup`` maps feature ids to vectors
    (a gather, no autograd link to the tables); ``sparse_update`` applies the
    row-sparse optimizer to one array in place."""

    def __init__(self, specs: list[EmbeddingSpec], *, fused_kind: str = "adam",
                 stack_tables: bool = False,
                 hot_ids: Mapping[str, np.ndarray] | None = None,
                 cache_rows: int = 0, mesh=None,
                 a2a_capacity_factor: float | None = None,
                 grouped_a2a: bool = False):
        """``hot_ids``: table or feature name -> that table's sorted hot ids
        (the frequency-partitioned mode); ``cache_rows``: rows of the
        update cache of every row-sparse plain array (0: off); ``mesh``: a
        ``DeviceMesh`` whose ``model`` axis shards the tables (None: one
        device); ``a2a_capacity_factor``: the alltoall lookup's per-owner
        send capacity as a multiple of ``local batch / M`` (None or <= 0:
        the exact worst case; ids past a full bucket read zeros);
        ``grouped_a2a``: the ``alltoall`` lookup and the step's update of
        every row- and table-sharded table ride the grouped exchange (the
        module note) instead of one exchange pair per table."""
        line_layout(1, fused_kind)  # validates the kind eagerly
        if cache_rows < 0:
            raise ValueError("cache_rows must be >= 0")
        self.mesh = mesh
        self.n_shards = axis_size(mesh, MODEL_AXIS)
        self.shard = axis_index(mesh, MODEL_AXIS)
        if a2a_capacity_factor is not None and a2a_capacity_factor <= 0:
            a2a_capacity_factor = None
        self.a2a_capacity_factor = a2a_capacity_factor
        self.grouped_a2a = grouped_a2a
        self._grouped_plans: dict[tuple[str, ...], tuple[_A2AGroup, ...]] = {}
        self.cache_rows = cache_rows
        self.fused_kind = fused_kind
        self.specs = {s.name: s for s in specs}
        if len(self.specs) != len(specs):
            raise ValueError("duplicate table names")
        self._feature_to_table: dict[str, str] = {}
        for s in specs:
            if s.sharding not in ("row", "replicated", "table", "column"):
                raise ValueError(f"table {s.name!r}: unknown sharding "
                                 f"{s.sharding!r}")
            if s.fused and s.sharding not in ("row", "replicated"):
                raise ValueError(
                    f"table {s.name!r}: fused storage supports row/replicated "
                    f"sharding, not {s.sharding!r}")
            if _spec_is_int8(s) and s.sharding == "column":
                raise ValueError(
                    f"table {s.name!r}: int8 storage supports row/"
                    "replicated/table sharding, not 'column'")
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
                if shard_kind == "row":  # shards own whole lines
                    unit *= self.n_shards
                total = _round_up(total, unit)
                off = 0
                for s in group:
                    self._stack_rows[s.name] = (off, total)
                    self._member_to_stack[s.name] = gname
                    off += s.num_embeddings
                self._stacks[gname] = (shard_kind, dim, group, fused)

        build_stacks([s for s in specs if s.fused], fused=True)
        if stack_tables:
            build_stacks([s for s in specs if not s.fused
                          and s.sharding in ("row", "replicated")], fused=False)
        # table-wise: same-dim tables stack into one array whose shard i of
        # M holds tables i, i+M, ... (each slot padded to the tallest)
        table_wise = [s for s in specs if s.sharding == "table"]
        if table_wise and mesh is None:
            raise ValueError("table-wise sharding requires a mesh")
        by_dim: dict[int, list[EmbeddingSpec]] = {}
        for s in table_wise:
            by_dim.setdefault(s.embedding_dim, []).append(s)
        for dim, group in by_dim.items():
            if len({s.dtype for s in group}) > 1:
                raise ValueError(
                    "table-wise tables stacked into one array must share "
                    f"a dtype; got {[(s.name, s.dtype) for s in group]}")
            m = self.n_shards
            slots = [group[i::m] for i in range(m)]
            slot_rows = max(1, max(sum(s.num_embeddings for s in sl)
                                   for sl in slots))
            for i, sl in enumerate(slots):
                off = i * slot_rows
                for s in sl:
                    self._stack_rows[s.name] = (off, slot_rows * m)
                    self._member_to_stack[s.name] = f"__stack_{dim}"
                    off += s.num_embeddings
            self._stacks[f"__stack_{dim}"] = ("table", dim, group, False)

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

    @staticmethod
    def _parent(array_name: str) -> str:
        """The array an int8 sidecar belongs to (any other name: itself)."""
        return array_name.removeprefix(QSCALE_PREFIX)

    def _array_spec(self, array_name: str) -> EmbeddingSpec:
        """A spec of the array (a stack's members share dim and dtype)."""
        if array_name in self._stacks:
            return self._stacks[array_name][2][0]
        return self.specs[array_name]

    def fat_layout_for(self, array_name: str):
        spec = self._array_spec(array_name)
        return self.fat_layout(spec.embedding_dim, spec.dtype)

    # ------------------------------------------------------------ sharding

    def array_placement(self, array_name: str) -> str:
        """How an array lies over the model axis: ``"row"`` (rows split;
        row and table sharding), ``"column"`` or ``"replicated"`` (always
        ``"replicated"`` without a mesh).  An int8 sidecar lies as its
        array does."""
        array_name = self._parent(array_name)
        if self.mesh is None:
            return "replicated"
        if array_name in self._stacks:
            kind = self._stacks[array_name][0]
        elif array_name in self.specs:
            kind = self.specs[array_name].sharding
        else:  # hot heads
            return "replicated"
        return {"table": "row"}.get(kind, kind)

    def array_rows(self, array_name: str) -> int:
        """Global padded vocab rows of an array (fat arrays count rows, not
        lines), from the specs alone; an int8 sidecar has its array's."""
        array_name = self._parent(array_name)
        if array_name in self._stacks:
            return self._stack_rows[self._stacks[array_name][2][0].name][1]
        spec = self.specs[array_name]
        unit = self.fat_layout(spec.embedding_dim, spec.dtype).r if spec.fused else 1
        if spec.sharding == "row":
            unit *= self.n_shards
        return _round_up(spec.num_embeddings, unit)

    def single_device_rows(self, array_name: str) -> int:
        """The rows the same array has on one device (no mesh): the
        checkpoint layout.  Table-wise stacks exist only under a mesh and
        keep their rows."""
        array_name = self._parent(array_name)
        if array_name in self._stacks:
            kind, dim, group, fused = self._stacks[array_name]
            if kind == "table":
                return self.array_rows(array_name)
            unit = self.fat_layout(dim, group[0].dtype).r if fused else 1
            return _round_up(sum(s.num_embeddings for s in group), unit)
        spec = self.specs[array_name]
        unit = self.fat_layout(spec.embedding_dim, spec.dtype).r if spec.fused else 1
        return _round_up(spec.num_embeddings, unit)

    def rows_per_shard(self, array_name: str) -> int:
        """Vocab rows each model shard of a row-placed array owns."""
        return self.array_rows(array_name) // self.n_shards

    def _model_group(self):
        return axis_group(self.mesh, MODEL_AXIS)

    def split_rows(self, array_name: str) -> int | None:
        """Rows per shard of an array whose rows split over more than one
        model rank; None when every rank holds all its rows."""
        if self.n_shards == 1 or self.array_placement(array_name) != "row":
            return None
        return self.rows_per_shard(array_name)

    def owner_gather(self, array_name: str):
        """``take(t, rows) -> t[rows]`` on every rank, for ``t`` the array
        ``array_name`` (this rank's shard of it), its int8 sidecar or a
        row-aligned slot, and ``rows`` global array rows (clamped into the
        array).  Where the rows split over the model axis each rank gathers
        the rows it owns and adds -0.0 (0 for integer storage) for the
        others: one sum over the axis then gives every rank the owner's
        bits (x + -0.0 == x for every float x, -0.0 and NaN included)."""
        rps = self.split_rows(array_name)
        if rps is None:
            return lambda t, rows: t[torch.clamp(rows, 0, t.shape[0] - 1)]
        v, k, group = rps * self.n_shards, self.shard, self._model_group()

        def take(t, rows):
            local = torch.clamp(rows, 0, v - 1) - k * rps
            mine = (local >= 0) & (local < rps)
            got = t[torch.clamp(local, 0, rps - 1)]
            fill = -0.0 if got.is_floating_point() else 0
            mine = mine.reshape(mine.shape + (1,) * (got.dim() - mine.dim()))
            return all_reduce_(torch.where(mine, got, fill), group)

        return take

    def owned_rows(self, array_name: str):
        """``owned(rows) -> (local rows, mine)``: where this rank's shard
        holds each global row of ``array_name`` (the update cache's flush
        writes only those); None when every rank holds all its rows."""
        rps = self.split_rows(array_name)
        if rps is None:
            return None
        k = self.shard

        def owned(rows):
            local = rows - k * rps
            return local, (local >= 0) & (local < rps)

        return owned

    def init(self, seed: int = 0, *, device="cuda") -> dict[str, torch.Tensor]:
        """Create all tables on ``device`` (default the card; ``"cpu"`` must
        be asked for).  Uniform(-init_scale, init_scale) per table from a
        ``torch.Generator`` seeded with ``seed``, drawn in f32 (one draw a
        table) and stored at the spec's dtype; optimizer
        state in fat lines starts at zero; stack padding rows are zero.
        Under a mesh every rank draws each whole table as the single-device
        init does and keeps its shard (rows past the single-device padding
        are zero)."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        m, k = self.n_shards, self.shard

        def draw_into(dst, lo, cols, spec, rows, at):
            """Draw ``rows`` rows of ``spec`` as array rows ``[at, at +
            rows)``; keep the part inside ``dst`` (array rows ``[lo, lo +
            len(dst))``, columns ``cols``)."""
            t = torch.rand((rows, spec.embedding_dim), generator=gen,
                           device=device, dtype=torch.float32)
            t.mul_(2 * spec.init_scale).sub_(spec.init_scale)
            a, b = max(at, lo), min(at + rows, lo + dst.shape[0])
            if a < b:
                dst[a - lo:b - lo] = t[a - at:b - at, cols]

        def local_block(aname, dim):
            """Zeros of this rank's part of array ``aname`` and where it
            lies: ``(dst, first row, column slice)``."""
            place = self.array_placement(aname)
            rows = self.array_rows(aname)
            lo, n_rows, cols = 0, rows, slice(0, dim)
            if place == "row":
                n_rows = rows // m
                lo = k * n_rows
            elif place == "column":
                if dim % m:
                    raise ValueError(
                        f"table {aname}: embedding_dim {dim} not divisible "
                        f"by {m} column shards")
                cols = slice(k * dim // m, (k + 1) * dim // m)
            dst = torch.zeros((n_rows, cols.stop - cols.start),
                              dtype=torch.float32, device=device)
            return dst, lo, cols

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
            t, lo, cols = local_block(name, spec.embedding_dim)
            draw_into(t, lo, cols, spec, self.single_device_rows(name), 0)
            place(name, t, spec, spec.fused)
        for gname, (_, dim, group, fused) in self._stacks.items():
            t, lo, cols = local_block(gname, dim)
            for s in group:
                draw_into(t, lo, cols, s, s.num_embeddings,
                          self._stack_rows[s.name][0])
            place(gname, t, group[0], fused)
            del t
        # hot heads: a gather of the initialised cold rows (at the table's
        # dtype; int8 decodes to an f32 head), so a hot/cold run starts
        # from the unsplit run's tables; the cold copies of hot rows are
        # never read or updated again.  Under a mesh each head is
        # replicated, every row read from the rank that owns it
        for tname in sorted(self.hot_ids):
            aname, _, off = self.resolve_table(tname)
            idx = torch.from_numpy(self.hot_ids[tname].astype(np.int64) + off
                                   ).to(device)
            take = self.owner_gather(aname)
            hot = take(tables[aname], idx)
            if self.array_is_int8(aname):
                hot = dequantize_rows(hot, take(tables[qscale_name(aname)], idx))
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
            if (opt.kind == "adam"
                    and self.array_rows(aname) <= opt.small_vocab_threshold
                    and not self.array_is_int8(aname)):
                continue
            out.append(aname)
        return tuple(out)

    def init_caches(self, tables, opt) -> dict[str, dict]:
        """Empty update caches for every cached array, keyed
        ``CACHE_PREFIX + array name`` (the trainer merges them into the
        slots, so checkpoints and rollback snapshots carry them).  Under a
        mesh each rank builds the same directory; a column shard's cache
        holds its columns (the module note)."""
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
        reads: see :func:`take_fill` and ``fat_gather_rows``.  Under a
        mesh, row-placed arrays run the ``psum`` program (``gspmd`` too,
        with the fill rule on the global padded table) or the
        ``alltoall`` one, whose ids are this rank's share of the batch
        (with ``grouped_a2a``, :meth:`grouped_lookup` for every row- and
        table-sharded feature); column arrays gather their columns and
        all-gather them (``gspmd`` only, as in the reference); replicated
        arrays gather locally.  The vectors of the per-table programs are
        differentiable with respect to the local shards
        (:mod:`~tdfo_tpu_torch.parallel.collectives`)."""
        if mode not in ("gspmd", "psum", "alltoall"):
            raise ValueError(f"unknown lookup mode {mode!r}")
        out: dict[str, torch.Tensor] = {}
        grouped = self.grouped_features(features) if mode == "alltoall" else {}
        if grouped:
            # the rest (replicated tables, the error paths) go on below
            out.update(self.grouped_lookup(tables, grouped))
            features = {f: i for f, i in features.items() if f not in grouped}
        for feat, ids in features.items():
            if self._feature_to_table.get(feat) in self.hot_ids:
                if mode != "gspmd":
                    raise ValueError(
                        "hot/cold tables compose with lookup mode 'gspmd' "
                        f"only, got {mode!r} for feature {feat!r}")
                out[feat] = self._lookup_hotcold(tables, feat, ids)
                continue
            aname, spec, offset = self.resolve(feat)
            gid = ids.to(torch.int64) + offset
            place = self.array_placement(aname)
            if place != "replicated" and mode != "gspmd" and place != "row":
                raise ValueError(
                    f"lookup mode {mode!r} requires row/table sharding, "
                    f"but table {spec.name!r} is {spec.sharding!r}")
            if place == "row" and mode == "alltoall":
                out[feat] = self._lookup_alltoall(tables, aname, spec, gid)
            elif place == "row":
                out[feat] = self._lookup_psum(tables, aname, spec, gid,
                                              fill=mode == "gspmd")
            elif place == "column":
                out[feat] = SeqGather.apply(
                    self._gather(tables, aname, spec, gid), self._model_group(), -1)
            else:
                out[feat] = self._gather(tables, aname, spec, gid)
        return out

    def _lookup_psum(self, tables, aname, spec, gid, fill: bool = False):
        """The psum program: this rank gathers the rows it owns, zeros
        elsewhere, and one sum over the model axis assembles the vectors
        (a sum with zeros, so exact).  ``fill``: ``jnp.take``'s rule on the
        global padded table (negatives wrap, ids past it read NaN);
        otherwise the reference's psum rule (any id no shard owns reads
        zeros)."""
        rps = self.rows_per_shard(aname)
        if fill:
            v = rps * self.n_shards
            gid = torch.where(gid < 0, gid + v, gid)
            inside = (gid >= 0) & (gid < v)
        local = gid - self.shard * rps
        mine = (local >= 0) & (local < rps)
        rows = self._gather(tables, aname, spec, local.clamp(0, rps - 1))
        rows = torch.where(mine[..., None], rows, 0.0)
        rows = AllReduceSum.apply(rows, self._model_group())
        if fill:
            rows = torch.where(inside[..., None], rows, float("nan"))
        return rows

    def _lookup_alltoall(self, tables, aname, spec, gid):
        """The alltoall program (torchrec input/output dist): bucket this
        rank's ids by owner (a stable sort), send each owner its bucket
        (``-1`` past the bucket's end), gather the received ids' rows,
        send the rows back and put them in the ids' order.  Buckets hold
        ``_a2a_bucket_cap`` ids; ids past a full bucket read zeros."""
        shape = gid.shape
        flat = gid.reshape(-1)
        n, m = flat.shape[0], self.n_shards
        rps = self.rows_per_shard(aname)
        cap = _a2a_bucket_cap(n, m, self.a2a_capacity_factor)
        dev = flat.device
        owner = torch.clamp(torch.div(flat, rps, rounding_mode="floor"), 0, m - 1)
        sorted_owner, order = torch.sort(owner, stable=True)
        sorted_ids = flat[order]
        start = torch.searchsorted(sorted_owner, torch.arange(m, device=dev))
        end = torch.cat([start[1:], torch.tensor([n], device=dev)])
        src = start[:, None] + torch.arange(cap, device=dev)[None, :]
        send = torch.where(src < end[:, None],
                           sorted_ids[torch.clamp(src, max=n - 1)], -1)
        group = self._model_group()
        recv = all_to_all(send.reshape(-1), group)
        local = recv - self.shard * rps
        rows = self._gather(tables, aname, spec, local.clamp(0, rps - 1))
        rows = torch.where((recv >= 0)[:, None], rows, 0.0)
        back = AllToAll.apply(rows, group)
        pos = torch.arange(n, device=dev) - start[sorted_owner]
        slot = torch.where(pos < cap, sorted_owner * cap + pos, -1)
        slot_inv = torch.empty_like(slot)
        slot_inv[order] = slot
        out = torch.where((slot_inv >= 0)[:, None],
                          back[slot_inv.clamp_min(0)], 0.0)
        return out.reshape(*shape, out.shape[-1])

    def a2a_fill_stats(self, tables, features):
        """Send-bucket use of the alltoall lookup for this batch:
        ``(fill, dropped)``, the f32 share of the buckets' capacity that
        carried ids and the int32 count of ids past a full bucket (read as
        zeros), both summed over the ranks that split the batch (the
        reference's ``a2a_fill_stats`` sums over the model axis, its only
        split; ``features`` hold each rank's share).  Grouped features
        count one bucket set per group's combined stream."""
        dev = next(iter(features.values())).device
        stats = torch.zeros((3,), dtype=torch.int64, device=dev)
        if self.mesh is None:
            return torch.zeros((), device=dev), torch.zeros((), dtype=torch.int32, device=dev)
        m = self.n_shards

        def bucket_stats(owner):
            cap = _a2a_bucket_cap(owner.shape[0], m, self.a2a_capacity_factor)
            counts = (owner[None, :] == torch.arange(m, device=dev)[:, None]).sum(1)
            return torch.stack([counts.clamp(max=cap).sum(),
                                torch.full((), m * cap, device=dev),
                                (counts - cap).clamp_min(0).sum()])

        # one capacity over each group's combined stream, the cap the
        # grouped exchange sizes its buckets with
        grouped = self.grouped_features(features)
        for g in self._grouped_plan(tuple(grouped)):
            owner, _ = self._owner_virt(self._group_flats(g, grouped),
                                        self._group_feat_rps(g))
            stats += bucket_stats(owner)
        features = {f: i for f, i in features.items() if f not in grouped}
        for feat, ids in features.items():
            aname, spec, offset = self.resolve(feat)
            if self.array_placement(aname) != "row":
                continue
            flat = ids.reshape(-1).to(torch.int64) + offset
            stats += bucket_stats(torch.clamp(torch.div(
                flat, self.rows_per_shard(aname), rounding_mode="floor"), 0, m - 1))
        all_reduce_(stats, self._model_group())
        all_reduce_(stats, axis_group(self.mesh, DATA_AXIS))
        fill = stats[0].to(torch.float32) / stats[1].clamp_min(1).to(torch.float32)
        return fill, stats[2].to(torch.int32)

    def a2a_overflow(self, tables, features):
        """Ids of this batch that the alltoall lookup drops under a finite
        ``a2a_capacity_factor`` (they read zeros), summed over the ranks
        that split the batch: an int32 0-dim tensor (reference
        ``a2a_overflow``)."""
        return self.a2a_fill_stats(tables, features)[1]

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
        padding ids read head row 0).  A cold array whose rows split over
        the model axis runs the ``gspmd`` program."""
        tname = self._feature_to_table[feat]
        hot_pos, cold_ids = self.route_ids(feat, ids)
        hot = tables[self.hot_array_name(tname)]
        hot_vec = hot[torch.clamp(hot_pos.to(torch.int64), min=0)]
        if self._hot_full[tname]:
            return hot_vec
        aname, spec, offset = self.resolve(feat)
        cidx = torch.where(cold_ids >= 0, cold_ids.to(torch.int64) + offset, 0)
        if self.split_rows(aname) is None:
            cold_vec = self._gather(tables, aname, spec, cidx)
        else:
            cold_vec = self._lookup_psum(tables, aname, spec, cidx, fill=True)
        return torch.where((hot_pos >= 0)[..., None], hot_vec.to(cold_vec.dtype),
                           cold_vec)

    # ----------------------------------------------------- grouped exchange

    def grouped_features(self, features):
        """The part of ``features`` the grouped exchange carries, in the
        order given: those of row- and table-sharded tables (none without
        ``grouped_a2a`` or a mesh)."""
        if not (self.grouped_a2a and self.mesh is not None):
            return {}
        return {f: ids for f, ids in features.items()
                if self._feature_to_table.get(f) not in self.hot_ids
                and self.resolve(f)[1].sharding in ("row", "table")}

    def _grouped_plan(self, feature_names: tuple[str, ...]) -> tuple[_A2AGroup, ...]:
        """The exchange plan of a feature set (reference ``_grouped_plan``):
        one :class:`_A2AGroup` per ``(embedding_dim, storage dtype)``, the
        features in the order given (the combined stream's order, which
        the update's summation order follows)."""
        plan = self._grouped_plans.get(feature_names)
        if plan is not None:
            return plan
        groups: dict[tuple[int, str], dict] = {}
        for f in feature_names:
            if self._feature_to_table.get(f, f) in self.hot_ids:
                raise ValueError(
                    f"feature {f!r}: hot/cold tables do not compose with "
                    "the grouped alltoall exchange")
            aname, spec, off = self.resolve(f)
            if spec.sharding not in ("row", "table"):
                raise ValueError(
                    f"grouped alltoall requires row/table sharding, but "
                    f"table {spec.name!r} is {spec.sharding!r}")
            grp = groups.setdefault((spec.embedding_dim, _dtype_name(spec.dtype)),
                                    {"arrays": [], "feats": []})
            if aname not in grp["arrays"]:
                grp["arrays"].append(aname)
            grp["feats"].append((f, grp["arrays"].index(aname), off))
        entries = []
        for (dim, dt), grp in sorted(groups.items(), key=lambda kv: str(kv[0])):
            arrays = tuple(grp["arrays"])
            rps = tuple(self.rows_per_shard(a) for a in arrays)
            bases = tuple(sum(rps[:i]) for i in range(len(rps)))
            entries.append(_A2AGroup(
                key=f"{dim}_{dt}", dim=dim,
                feats=tuple(x[0] for x in grp["feats"]),
                feat_meta=tuple((x[1], x[2]) for x in grp["feats"]),
                arrays=arrays, specs=tuple(self._array_spec(a) for a in arrays),
                rows_per_shard=rps, bases=bases))
        plan = tuple(entries)
        self._grouped_plans[feature_names] = plan
        return plan

    def _group_flats(self, group: _A2AGroup, features) -> list[torch.Tensor]:
        """Each feature's flat ids with its row offset added; padding ids
        stay -1 (an offset would alias them onto the previous stack
        member's last row)."""
        out = []
        for f, (_, off) in zip(group.feats, group.feat_meta):
            flat = features[f].reshape(-1).to(torch.int64)
            out.append(torch.where(flat >= 0, flat + off, -1))
        return out

    def _group_feat_rps(self, group: _A2AGroup) -> tuple:
        """Each feature's ``(rows_per_shard, base)`` (of its array)."""
        return tuple((group.rows_per_shard[ai], group.bases[ai])
                     for ai, _ in group.feat_meta)

    def _owner_virt(self, flats, feat_rps):
        """The combined ``(owner, virtual id)`` stream of a group.  Padding
        ids keep virtual id -1: they bucket to shard 0 as in the per-table
        program, arrive invalid and read zeros / drop their grads."""
        m = self.n_shards
        owners, virts = [], []
        for part, (rps, base) in zip(flats, feat_rps):
            o = torch.clamp(torch.div(part, rps, rounding_mode="floor"), 0, m - 1)
            owners.append(o)
            virts.append(torch.where(part >= 0, part - o * rps + base, -1))
        return torch.cat(owners), torch.cat(virts)

    def _buckets(self, owner, cap: int):
        """The stable owner sort of a stream of ``n``: ``(order, src, valid,
        slot)`` with ``src [M, cap]`` the sorted positions each owner's
        bucket sends (``valid`` where a bucket has that many ids) and
        ``slot [n]`` each sorted position's place in the send buffer (-1
        past a full bucket).  Stable, so each bucket keeps stream order and
        the forward and the update drop the same ids."""
        n, m, dev = owner.shape[0], self.n_shards, owner.device
        sorted_owner, order = torch.sort(owner, stable=True)
        start = torch.searchsorted(sorted_owner, torch.arange(m, device=dev))
        end = torch.cat([start[1:], torch.full((1,), n, device=dev, dtype=start.dtype)])
        src = start[:, None] + torch.arange(cap, device=dev)[None, :]
        valid = src < end[:, None]
        pos = torch.arange(n, device=dev) - start[sorted_owner]
        slot = torch.where(pos < cap, sorted_owner * cap + pos, -1)
        return order, torch.clamp(src, max=n - 1), valid, slot

    def grouped_input_dist(self, features, *, async_op: bool = False) -> dict:
        """Phase 1 of the grouped exchange (reference
        ``grouped_input_dist``): per group one stable owner sort and one id
        ``all_to_all`` of the combined virtual id stream.  Reads no table,
        so the pipelined step issues it for the next batch before the
        current one trains.  ``features`` hold this rank's share.  Returns
        ``{group key: _Dist}``; with ``async_op`` the id exchanges are
        left in flight (:meth:`grouped_lookup` waits on them)."""
        plan = self._grouped_plan(tuple(features))
        group = self._model_group()
        ctx = {}
        for g in plan:
            owner, virt = self._owner_virt(self._group_flats(g, features),
                                           self._group_feat_rps(g))
            cap = _a2a_bucket_cap(owner.shape[0], self.n_shards,
                                  self.a2a_capacity_factor)
            order, src, valid, slot = self._buckets(owner, cap)
            send = torch.where(valid, virt[order][src], -1).reshape(-1)
            slot_inv = torch.empty_like(slot)
            slot_inv[order] = slot
            if async_op:
                recv, work = all_to_all(send, group, async_op=True)
                ctx[g.key] = _Dist(recv, slot_inv, work, send)
            else:
                ctx[g.key] = _Dist(all_to_all(send, group), slot_inv)
        return ctx

    def _wire_dtype(self, g: _A2AGroup):
        """The vector payload's dtype: the storage dtype; an int8 group
        with a fused member ships f32 (its rows arrive decoded)."""
        dt = storage_dtype(g.specs[0].dtype)
        if dt == torch.int8 and any(s.fused for s in g.specs):
            return torch.float32
        return dt

    def grouped_lookup(self, tables, features, ctx: dict | None = None):
        """Complete a :meth:`grouped_input_dist` ctx (or run it here) with
        the owners' gathers and ONE vector ``all_to_all`` per group, at the
        storage dtype (reference ``grouped_lookup``): plain int8 ships its
        codes and a second, ``[.., 2]`` f32 exchange of their ``(scale,
        offset)`` rows (a fused int8 member of such a group decodes in the
        gather and rides the identity grid), decoded after the exchange;
        f32 out.  The values equal the per-table program's."""
        plan = self._grouped_plan(tuple(features))
        if ctx is None:
            ctx = self.grouped_input_dist(features)
        group = self._model_group()
        out: dict[str, torch.Tensor] = {}
        for g in plan:
            dist_ = ctx[g.key]
            recv = dist_.wait()
            wire = self._wire_dtype(g)
            int8 = storage_dtype(g.specs[0].dtype) == torch.int8
            plain8 = int8 and any(not s.fused for s in g.specs)
            vec = torch.zeros((recv.shape[0], g.dim), dtype=wire, device=recv.device)
            qvec = (torch.zeros((recv.shape[0], 2), dtype=torch.float32,
                                device=recv.device) if plain8 else None)
            for aname, spec, rps, base in zip(g.arrays, g.specs,
                                              g.rows_per_shard, g.bases):
                loc = recv - base
                mine = (recv >= 0) & (loc >= 0) & (loc < rps)
                idx = loc.clamp(0, rps - 1)
                if spec.fused:
                    rows = fat_gather_rows(tables[aname], idx,
                                           self.fat_layout_for(aname))
                else:
                    rows = tables[aname][idx]
                vec = torch.where(mine[:, None], rows.to(wire), vec)
                if plain8:
                    q = (tables[qscale_name(aname)][idx] if not spec.fused
                         else torch.tensor([1.0, 0.0], device=recv.device))
                    qvec = torch.where(mine[:, None], q, qvec)
            back = AllToAll.apply(vec, group)
            # decode after the exchange: the model sees f32 whatever the
            # storage dtype
            flat = (dequantize_rows(back, all_to_all(qvec, group)) if plain8
                    else back.to(torch.float32))
            slot_inv = dist_.slot_inv
            outv = torch.where((slot_inv >= 0)[:, None],
                               flat[slot_inv.clamp_min(0)], 0.0)
            o = 0
            for f in g.feats:
                n = features[f].numel()
                out[f] = outv[o:o + n].reshape(*features[f].shape, g.dim)
                o += n
        return out

    def grouped_update(self, opt, tables, slots, ids, grads, sr_key=None):
        """The update half of the grouped exchange (reference
        ``grouped_update``): per group ONE id and ONE grad ``all_to_all``
        send each owner its contributions (the stable sort keeps them in
        global batch order; ids past a full bucket drop their grads, the
        ids whose forward read zeros), then each rank updates its shards
        in place: fat arrays through ``fat_update`` (the
        ``fat_line_update`` kernel), plain ones through ``dedupe_grads``
        (the ``segment_sum`` kernel) and ``update_unique`` (small adam
        arrays too, where the per-table path takes the dense tier).
        ``ids`` / ``grads``: this rank's share, by feature; under a data
        axis the received streams are gathered over it first.
        ``sr_key``: the step's base key for narrow storage, folded with
        each array's ``table_id`` and the model index.  In place."""
        from tdfo_tpu_torch.ops.sparse import dedupe_grads, fat_update

        plan = self._grouped_plan(tuple(ids))
        m, group = self.n_shards, self._model_group()
        data = axis_group(self.mesh, DATA_AXIS) if axis_size(
            self.mesh, DATA_AXIS) > 1 else None
        for g in plan:
            owner, virt = self._owner_virt(self._group_flats(g, ids),
                                           self._group_feat_rps(g))
            gcat = torch.cat([grads[f].reshape(-1, g.dim) for f in g.feats]
                             ).to(torch.float32)
            cap = _a2a_bucket_cap(owner.shape[0], m, self.a2a_capacity_factor)
            order, src, valid, _ = self._buckets(owner, cap)
            send_ids = torch.where(valid, virt[order][src], -1).reshape(-1)
            send_g = torch.where(valid[..., None], gcat[order][src], 0.0)
            recv_ids = all_to_all(send_ids, group)
            recv_g = all_to_all(send_g.reshape(-1, g.dim), group)
            if data is not None:  # every data replica's contributions
                recv_ids = all_gather_cat(recv_ids, data)
                recv_g = all_gather_cat(recv_g, data)
            stream = recv_ids.shape[0]
            for aname, spec, rps, base in zip(g.arrays, g.specs,
                                              g.rows_per_shard, g.bases):
                loc = recv_ids - base
                mine = (recv_ids >= 0) & (loc >= 0) & (loc < rps)
                mids = torch.where(mine, loc, -1)
                mg = torch.where(mine[:, None], recv_g, 0.0)
                sk = None
                if sr_key is not None:
                    sk = threefry.fold_in(threefry.fold_in(sr_key, table_id(aname)),
                                          self.shard)
                # distinct bound: a shard touches at most the rows (fat
                # f32/bf16: lines) it owns, +1 for the sentinel slot
                unit = (self.fat_layout_for(aname).r if spec.fused
                        and not _spec_is_int8(spec) else 1)
                md = min(stream, _round_up(rps // unit + 1, 8))
                if spec.fused:
                    fat_update(tables[aname], slots[aname], mids, mg,
                               embedding_dim=g.dim, kind=self.fused_kind,
                               lr=opt.lr, b1=opt.b1, b2=opt.b2, eps=opt.eps,
                               weight_decay=opt.weight_decay, capacity=md,
                               max_distinct=md, sr_key=sk)
                else:
                    uids, gu, ok = dedupe_grads(mids, mg, capacity=md, vocab=rps,
                                                max_distinct=md)
                    opt.update_unique(tables[aname], slots[aname], uids, gu, ok,
                                      embedding_dim=g.dim, sr_key=sk,
                                      qscale=tables.get(qscale_name(aname)))

    # -------------------------------------------------------------- update

    def sparse_update(self, opt, array_name: str, table, slots, ids, grads,
                      max_distinct: int | None = None, sr_key=None,
                      qscale=None):
        """Apply the row-sparse optimizer to one array (in place; returns
        ``(table, slots)``, ``+ (qscale,)`` for a plain int8 array).
        ``ids`` / ``grads`` are the GLOBAL batch's (the step gathers them
        over the ranks that split it).  Replicated arrays update whole; a
        row-placed shard keeps the ids it owns, rebased by ``k R``, and
        turns the others into -1 with zero grads (the reference's
        ``shard_map`` update, ``sparse_update``; a fat shard launches the
        ``fat_line_update`` kernel on its own lines); a column shard
        updates its columns.  Narrow storage folds the stochastic-rounding
        key with the model index, so shards draw their own bits.  The small
        adam tier is chosen by the global rows, as on one device."""
        d = self.array_embedding_dim(array_name)
        place = self.array_placement(array_name)
        kw = dict(capacity=max_distinct, max_distinct=max_distinct,
                  qscale=qscale, vocab_rows=self.array_rows(array_name))
        if place == "replicated":
            return opt.update(table, slots, ids, grads, embedding_dim=d,
                              sr_key=sr_key, **kw)
        ids = ids.reshape(-1).to(torch.int64)
        grads = grads.reshape(-1, grads.shape[-1])
        if place == "column":
            grads, sr_key = self.column_share(grads, sr_key)
            return opt.update(table, slots, ids, grads,
                              embedding_dim=grads.shape[-1], sr_key=sr_key,
                              row_sq_mean=self._whole_row_sq_mean, **kw)
        if sr_key is not None:
            sr_key = threefry.fold_in(sr_key, self.shard)
        rps = self.rows_per_shard(array_name)
        local = ids - self.shard * rps
        mine = (local >= 0) & (local < rps)
        return opt.update(table, slots, torch.where(mine, local, -1),
                          torch.where(mine[:, None], grads, 0.0),
                          embedding_dim=d, sr_key=sr_key, **kw)

    def column_share(self, grads, sr_key=None):
        """A column shard's part of whole-row grads ``[n, d]``: its
        columns ``[n, d / M]`` and the rounding key folded with its model
        index (each shard draws its own bits)."""
        w = grads.shape[-1] // self.n_shards
        if sr_key is not None:
            sr_key = threefry.fold_in(sr_key, self.shard)
        return grads[:, self.shard * w:(self.shard + 1) * w], sr_key

    def _whole_row_sq_mean(self, g):
        """rowwise_adagrad's per-row mean of squares for a column shard's
        ``g [C, d / M]``: the model axis's blocks all-gathered in column
        order, then one mean over the whole row, so every rank adds the
        single-device value to its copy of the ``[V]`` accumulator."""
        full = all_gather_cat(g, self._model_group(), dim=-1)
        return torch.mean(full * full, dim=-1)

    def update_unique(self, opt, array_name: str, table, slots, uids, g,
                      valid, sr_key=None, qscale=None):
        """The dedup-lookup step's update of one array from the GLOBAL
        batch's distinct rows ``(uids, g, valid)`` (``opt.update_unique``,
        in place).  Where the rows split over the model axis a rank keeps
        the distinct rows it owns, rebased by ``k R``, the others becoming
        invalid sentinels: the ``[C, d]`` block and the rounding key stay
        the single-device ones, so each owned row gets the single-device
        row's bits.  Column shards take :meth:`sparse_update`."""
        rps = self.split_rows(array_name)
        if rps is not None:
            local = uids.to(torch.int64) - self.shard * rps
            valid = valid & (local >= 0) & (local < rps)
            uids = torch.where(valid, local, SENTINEL).to(uids.dtype)
        return opt.update_unique(table, slots, uids, g, valid,
                                 embedding_dim=self.array_embedding_dim(array_name),
                                 sr_key=sr_key, qscale=qscale)

    # ---------------------------------------------------------- checkpoint

    def _slot_placement(self, array_name: str, table, t) -> str:
        """A slot tensor lies like its table when it has the table's rows
        (moments, row accumulators); scalars (adam's count) replicate."""
        if t.dim() == 0 or t.shape[0] != table.shape[0]:
            return "replicated"
        place = self.array_placement(array_name)
        # a column shard's rowwise accumulator is whole on every rank
        return "replicated" if place == "column" and t.dim() == 1 else place

    def _cache_placement(self, cache_name: str, t) -> str:
        """An update cache tensor over a column-sharded table holds this
        rank's columns when it has the table's width (value rows,
        elementwise mirrors); the directory, the per-row counters and a
        rowwise accumulator replicate."""
        parent = cache_name.removeprefix(CACHE_PREFIX)
        column = self.array_placement(parent) == "column"
        return "column" if column and t.dim() == 2 else "replicated"

    def _global_shape(self, array_name: str, t, place: str) -> tuple:
        """The single-device layout's shape of this rank's array ``t``."""
        if place == "replicated" or self.mesh is None:
            return tuple(t.shape)
        if place == "column":
            return (t.shape[0], t.shape[1] * self.n_shards, *t.shape[2:])
        r = self.fat_layout_for(array_name).r if t.dim() == 3 else 1
        return (self.single_device_rows(array_name) // r, *t.shape[1:])

    def _gather_one(self, array_name: str, t, place: str, root_only: bool):
        if place == "replicated" or self.mesh is None:
            return t
        group, dim = self._model_group(), 1 if place == "column" else 0
        full = (gather_to_host(t, group, dim) if root_only
                else all_gather_cat(t, group, dim=dim))
        if full is None or place == "column":
            return full
        return full[:self._global_shape(array_name, t, place)[0]]

    def _each_array(self, tables, slots, fn):
        """``fn(array name, tensor, placement)`` over every table and slot
        tensor, in one order on every rank (an update cache is a dict of
        tensors, :meth:`_cache_placement`)."""
        gt = {n: fn(n, t, self.array_placement(n)) for n, t in tables.items()}
        gs = {n: ({k: fn(n, t, self._cache_placement(n, t)) for k, t in sl.items()}
                  if isinstance(sl, dict) else
                  type(sl)(fn(n, t, self._slot_placement(n, tables[n], t))
                           for t in sl))
              for n, sl in slots.items()}
        return gt, gs

    def _shard_one(self, array_name: str, t, place: str):
        if place == "replicated" or self.mesh is None:
            return t
        m, k = self.n_shards, self.shard
        if place == "column":
            w = t.shape[1] // m
            return t[:, k * w:(k + 1) * w].contiguous()
        r = self.fat_layout_for(array_name).r if t.dim() == 3 else 1
        n = self.array_rows(array_name) // r
        if t.shape[0] > n:
            raise ValueError(f"array {array_name!r}: {t.shape[0]} saved rows "
                             f"do not fit {n} under this mesh")
        pad = t.new_zeros((n - t.shape[0], *t.shape[1:]))
        full = torch.cat([t, pad]) if pad.shape[0] else t
        return full[k * (n // m):(k + 1) * (n // m)].contiguous()

    def global_arrays(self, tables, slots, *, root_only: bool = False):
        """``(tables, slots)`` in the single-device layout, each sharded
        array gathered over the model axis, padding past the single-device
        rows dropped.  Table-wise stacks keep this mesh's layout.  Every
        rank calls this.  By default each gets the whole arrays on its
        device (for comparisons); with ``root_only`` (a checkpoint) only
        global rank 0 gets them, the sharded ones on its host, gathered a
        shard at a time, and the ranks off its model line take no part
        and get ``(None, None)``."""
        if self.mesh is None:
            return dict(tables), dict(slots)
        if root_only and (axis_index(self.mesh, DATA_AXIS)
                          or axis_index(self.mesh, SEQ_AXIS)):
            return None, None
        return self._each_array(tables, slots, lambda n, t, place: self._gather_one(
            n, t, place, root_only))

    def global_template(self, tables, slots):
        """Stand-ins for :meth:`global_arrays`'s result that take no memory:
        each sharded array as a zero-stride host tensor of its single-device
        shape and dtype (a checkpoint restore's template; the values are
        not the state's).  No collective runs."""
        if self.mesh is None:
            return dict(tables), dict(slots)

        def stand_in(n, t, place):
            if place == "replicated":
                return t
            return torch.empty((), dtype=t.dtype).expand(self._global_shape(n, t, place))

        return self._each_array(tables, slots, stand_in)

    def local_arrays(self, tables, slots):
        """The inverse of :meth:`global_arrays`: this rank's shards of
        single-device-layout arrays (padding rows added as zeros), so a
        checkpoint written at one world size restores at another."""
        if self.mesh is None:
            return dict(tables), dict(slots)

        lt = {n: self._shard_one(n, t, self.array_placement(n))
              for n, t in tables.items()}
        ls = {n: ({k: self._shard_one(n, t, self._cache_placement(n, t))
                  for k, t in sl.items()} if isinstance(sl, dict) else type(sl)(
                  self._shard_one(n, t, self._slot_placement(n, tables[n], t))
                  for t in sl))
              for n, sl in slots.items()}
        return lt, ls
