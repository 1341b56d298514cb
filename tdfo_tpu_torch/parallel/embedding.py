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

Storage dtype is a property of the spec (``float32`` or ``bfloat16``; int8
refuses, ``ROADMAP.md`` Queue A item 13): ``init`` draws in f32 and stores
narrow (round-to-nearest), lookups widen to f32 after the gather, and
tables of different dtypes never share a stack (bf16 stacks carry the
dtype suffix: ``__fatstack_{d}_{sharding}_bfloat16``,
``__tablestack_{d}_{sharding}_bfloat16``).

Ported: ``make_embedding_specs``, ``EmbeddingSpec`` and, on the
collection, ``init``, ``features``, ``resolve``, ``resolve_table``,
``fat_layout``, ``fat_layout_for``, ``array_embedding_dim``,
``lookup(mode="gspmd")`` and ``sparse_update``.  Not ported yet: meshes,
column/table sharding, the psum/alltoall lookups and the grouped exchange
(``ROADMAP.md`` Queue A item 12), hot/cold tables, the update cache and
int8 storage (item 13).  Refused, not ignored.  As in the reference,
bf16 fused tables under ``rowwise_adagrad`` refuse: a fat line holds the
table and its optimizer state at one dtype, and the per-row accumulator
is f32 by contract.

``init`` draws from a ``torch.Generator`` (the reference uses
``jax.random``, so same-seed tables differ between the packages; the
parity tests inject the reference's tables through ``interop``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from tdfo_tpu_torch.core.device import resolve_device
from tdfo_tpu_torch.ops.fat_lines import (
    _dtype_name,
    fat_gather_rows,
    fat_pack,
    line_layout,
)
from tdfo_tpu_torch.ops.quant import storage_dtype

__all__ = ["EmbeddingSpec", "ShardedEmbeddingCollection", "embedding_lookup",
           "make_embedding_specs", "take_fill"]


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
                 stack_tables: bool = False):
        line_layout(1, fused_kind)  # validates the kind eagerly
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
            dt = storage_dtype(s.dtype)  # f32 / bf16; int8 refuses (item 13)
            if (s.fused and dt == torch.bfloat16
                    and fused_kind == "rowwise_adagrad"):
                # fat lines pack table AND state at one dtype; the rowwise
                # accumulator is contractually f32 per row (fbgemm
                # EXACT_ROWWISE_ADAGRAD), so it cannot ride a bf16 line
                raise ValueError(
                    f"table {s.name!r}: fused rowwise_adagrad storage "
                    "cannot be bfloat16 (the per-row accumulator is f32 by "
                    "the fbgemm parity contract)")
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
        for name, spec in self.specs.items():
            if name in self._member_to_stack:
                continue
            lay = self.fat_layout(spec.embedding_dim, spec.dtype)
            unit = lay.r if spec.fused else 1
            rows = -(-spec.num_embeddings // unit) * unit
            t = draw(spec, rows)
            tables[name] = (fat_pack(t, kind=self.fused_kind, layout=lay)
                            if spec.fused else t.to(spec.dtype))
        for gname, (_, dim, group, fused) in self._stacks.items():
            total = self._stack_rows[group[0].name][1]
            t = torch.zeros((total, dim), dtype=torch.float32, device=device)
            for s in group:
                off, _ = self._stack_rows[s.name]
                t[off:off + s.num_embeddings] = draw(s, s.num_embeddings)
            tables[gname] = (fat_pack(t, kind=self.fused_kind,
                                      layout=self.fat_layout_for(gname))
                             if fused else t.to(group[0].dtype))
            del t
        return tables

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
            aname, spec, offset = self.resolve(feat)
            table = tables[aname]
            gid = ids.to(torch.int64) + offset
            if spec.fused:
                vecs = fat_gather_rows(table, gid, self.fat_layout_for(aname))
            else:
                vecs = take_fill(table, gid)
            out[feat] = vecs.to(torch.float32)  # widen after the gather
        return out

    # -------------------------------------------------------------- update

    def sparse_update(self, opt, array_name: str, table, slots, ids, grads,
                      max_distinct: int | None = None, sr_key=None):
        """Apply the row-sparse optimizer to one array (in place; returns
        ``(table, slots)``).  On one device every array takes
        ``opt.update`` directly (the reference's shard_map branch serves
        row-sharded fat tables on a real model axis)."""
        d = self.array_embedding_dim(array_name)
        return opt.update(table, slots, ids, grads, embedding_dim=d,
                          capacity=max_distinct, max_distinct=max_distinct,
                          sr_key=sr_key)
