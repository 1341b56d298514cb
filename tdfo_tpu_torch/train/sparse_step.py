"""Hybrid sparse/dense train step — port of the eager branches of
``tdfo_tpu/train/sparse_step.py::make_sparse_train_step``.

torchrec's DMP + CombinedOptimizer split, in PyTorch: the collection
gathers the rows a batch touches; ``torch.autograd.grad`` takes the loss
gradient with respect to the dense parameters and the GATHERED rows (never
a ``[V, d]`` table); AdamW steps the dense half; then every table array gets
one row-sparse update (``ops/sparse.py`` tiers — the fat-line tables go
through the ``fat_line_update`` kernel).  Tables and slots update in place.

``dedup_lookup=True`` is the TBE unique-then-expand recipe: per array ONE
sort dedupes the step's ids, the forward gathers the distinct rows only
and expands them per position, and the update segment-sums the grads by the
same mapping — no second dedupe.  Fat arrays take the routed form
(``dedupe_rows_and_lines``: gather the touched LINES, slot-select, expand;
update through the ``fat_line_update_routed`` kernel, which reads the
forward's gathered lines); plain arrays ``dedupe_ids``, a compact gather
and ``update_unique``, except small plain adam arrays, which keep the
raw-id dense tier.  Gathers follow the reference's: a negative id reads
row 0 of its array, a fat line past the table reads NaN.

Narrow storage: every array whose table is stored in bf16 or int8, or
whose optimizer slot is bf16, gets a stochastic-rounding key per step,
``ops.quant.sr_key(step, array name)`` (reference ``_sr_key``), derived on
the host from ``state.step``; f32 arrays get None, so their update is what
it was.  The gathered rows widen to f32 before the model sees them.  A
plain int8 array's ``__qscale__/`` sidecar is storage, not a parameter: it
has no slots and is written by its array's update.

Hot/cold collections: each split table's ids route once per step into
head positions and cold ids (hot hits become -1, padding for every later
stage); the forward selects the head's rows at hot hits, and the head
takes ``SparseOptimizer.dense_update`` (input-order segment sums and one
dense ``[K, D]`` step, where the reference contracts a one-hot matrix on
the MXU: the sums run in another order).  Fully hot tables have no cold
side at all.

Update cache (a state whose slots carry ``coll.init_caches``'s entries):
each cached array's update runs in its cache
(``SparseOptimizer.cache_update[_unique]``) and every gather of it is
overlaid with the cached rows, so nothing reads a stale table row; the
write-back is :func:`make_cache_flush_fn`'s, which the trainer runs every
``flush_every`` steps and before every save and eval.

Meshes (``coll.mesh``; ``core/mesh.py``): each rank runs the step on its
data slice of the global batch, and the collection's lookups run the
``gspmd`` / ``psum`` / ``alltoall`` programs (``parallel/embedding.py``).
Under ``alltoall`` the data slice splits again over the model axis, so
each rank computes the backbone on its share and the logits are gathered
back.  The ranks that split the batch (the data axis; data x model under
``alltoall``) are the batch group, of G ranks: the loss is divided by G
before the backward, the dense gradients are summed over the group (the
global batch's mean, as GSPMD computes it) and every array's ids and row
gradients are gathered over it, in global batch order, before
``coll.sparse_update`` keeps the rows this rank owns.  At G = 1 nothing is
scaled or gathered, so a ``gspmd`` or ``psum`` step on model shards sums
exactly what the single-device step sums.

The seq axis and tensor parallelism (Bert4Rec): the batch splits over
the data axis only (and model under ``alltoall``), so a seq or a
tensor-parallel model rank holds the same rows as its neighbours and the
batch group leaves them out: seq ranks end the backward with identical
gradients (the ring gathers its chunks' gradients), and the dense
gradients of a tensor-parallel shard are summed over the data axis alone
before AdamW steps each rank's shard; nothing is summed over seq.  The
step's dropout generator reaches the forward as this rank's share of the
global batch's rows (``BatchGroup.share``), so the masks are the
single-device step's.

Grouped exchange (a ``grouped_a2a`` collection under ``alltoall``): every
row- and table-sharded feature's forward rides the collection's grouped
lookup and their update is ONE ``coll.grouped_update`` (one id and one
grad ``all_to_all`` per group, each owner receiving only its own
contributions) instead of the gathers and per-array updates; its narrow
arrays' stochastic-rounding keys derive from ``sr_key(step,
"__grouped_update__")`` folded per array and rank.  Replicated tables keep
the per-array path beside it.  :func:`make_pipelined_sparse_train_step`
(torchrec ``TrainPipelineSparseDist``) issues the next batch's id
exchange, asynchronously, before it trains the carried batch.

``dedup_lookup``, hot/cold tables and the update cache under a mesh
(``gspmd`` only, as in the reference): the batch group's ids are gathered
in global batch order before the forward, so every rank dedupes the global
batch as one device does.  Where a table's rows are whole on every rank
(model 1, the Criteo recipe's data-parallel layout) the compact gather and
the update are the single-device ones, the routed fat-line kernel on the
replicated stack included; where they split over model ranks each rank
gathers the distinct rows it owns and one sum over the model axis
assembles them, a fat stack then taking the default sharded update
(``fat_line_update`` on each rank's lines) and a plain one the shared
dedupe restricted to its own rows (``coll.update_unique``).  Each rank
expands its own positions.  Column-sharded tables keep the default lookup
and update, as in the reference.  The hot heads and the caches' directories
are replicated: every rank runs the head step and the cache math on the
global batch's head positions, ids and grads, so every copy stays the same;
the cache's admission reads each row of a sharded table from its owner and
its flush writes each row into its owner only.  A column shard's cache
holds its columns: the step updates them from its columns of the grads
(rowwise_adagrad's mean over the whole row) and the forward all-gathers
the cached columns it serves.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from tdfo_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    axis_group,
    axis_index,
    axis_size,
    plane_group,
)
from tdfo_tpu_torch.obs import counters as obs_counters
from tdfo_tpu_torch.ops.kernels.fat_line_update import SENTINEL
from tdfo_tpu_torch.ops.quant import bytes_to_f32, dequantize_rows
from tdfo_tpu_torch.ops.quant import sr_key as _make_sr_key
from tdfo_tpu_torch.ops.sparse import (
    SparseOptimizer,
    _segment_sum,
    cache_lookup_rows,
    cache_overlay_rows,
    dedupe_ids,
    dedupe_rows_and_lines,
)
from tdfo_tpu_torch.parallel.collectives import (
    SeqGather,
    all_gather_cat,
    all_reduce_,
    all_reduce_tensors,
)
from tdfo_tpu_torch.parallel.embedding import (
    CACHE_PREFIX,
    QSCALE_PREFIX,
    ShardedEmbeddingCollection,
    qscale_name,
    take_fill,
)
from tdfo_tpu_torch.train.state import (
    clone_tree,
    load_optimizer_tensors,
    make_adamw,
    optimizer_tensors,
)
from tdfo_tpu_torch.train.step import global_norm as _global_norm
from tdfo_tpu_torch.train.step import model_group, model_split

__all__ = ["BatchGroup", "PipelinedSparseStep", "SparseTrainState",
           "make_cache_flush_fn", "make_pipelined_sparse_train_step",
           "make_sparse_train_step"]


class BatchGroup:
    """The ranks that split the global batch under ``mesh`` and lookup
    ``mode``: the data axis, and under ``alltoall`` the model axis too (the
    lookup's ids are each rank's share).  The seq axis never splits the
    batch: its ranks hold the same rows (and, outside the ring, compute the
    same things).  ``size`` is 1 without a mesh."""

    def __init__(self, mesh, mode: str):
        self.mesh = mesh
        self.model_split = (mesh is not None and mode == "alltoall")
        self.m = axis_size(mesh, MODEL_AXIS) if self.model_split else 1
        self.size = axis_size(mesh, DATA_AXIS) * self.m
        # this rank's place in the group's batch order (data-major)
        self.index = (axis_index(mesh, DATA_AXIS) * self.m
                      + (axis_index(mesh, MODEL_AXIS) if self.model_split else 0))
        if self.size == 1:
            self.group = None
        elif not self.model_split:
            self.group = axis_group(mesh, DATA_AXIS)
        elif axis_size(mesh, DATA_AXIS) == 1:
            self.group = axis_group(mesh, MODEL_AXIS)
        elif axis_size(mesh, SEQ_AXIS) == 1:  # data x model: every rank
            self.group = torch.distributed.group.WORLD
        else:  # the data x model plane of this rank's seq index
            self.group = plane_group(mesh, (DATA_AXIS, MODEL_AXIS))

    def share(self, generator):
        """The step's dropout generator with this rank's rows of the global
        batch (``models.transformer.RowShare``; as it is at size 1)."""
        if generator is None or self.size == 1:
            return generator
        from tdfo_tpu_torch.models.transformer import RowShare

        return RowShare(generator, self.size, self.index)

    def split(self, batch):
        """This rank's share of a data-local batch (every tensor's rows)."""
        if not self.model_split:
            return batch
        k = axis_index(self.mesh, MODEL_AXIS)

        def part(v):
            n = v.shape[0]
            if n % self.m:
                raise ValueError(f"batch of {n} rows does not split over "
                                 f"model = {self.m} (lookup mode 'alltoall')")
            return v[k * (n // self.m):(k + 1) * (n // self.m)]

        return {key: part(v) for key, v in batch.items()}

    def join(self, x):
        """Rows of the shares back into the data-local batch's order."""
        if not self.model_split:
            return x
        return all_gather_cat(x, axis_group(self.mesh, MODEL_AXIS))

    def gather(self, parts):
        """``parts`` ([n_i, ...] tensors of one dtype and trailing shape,
        this rank's rows) -> the same tensors over the whole group's batch,
        rows in global batch order; one collective."""
        if self.size == 1:
            return list(parts)
        flat = [p.reshape(p.shape[0], -1) for p in parts]
        n = sum(p.shape[0] for p in flat)
        allb = all_gather_cat(torch.cat(flat), self.group).view(self.size, n, -1)
        out, off = [], 0
        for p, f in zip(parts, flat):
            out.append(allb[:, off:off + f.shape[0]].reshape(
                self.size * f.shape[0], *p.shape[1:]))
            off += f.shape[0]
        return out

    def mean(self, x):
        """The group's mean of a per-rank value (a loss)."""
        if self.size == 1:
            return x
        return all_reduce_(x.detach().clone(), self.group) / self.size


def _array_is_narrow(state: "SparseTrainState", aname: str) -> bool:
    """True when ``aname``'s table is stored in bf16 or int8, or any
    floating optimizer slot in bf16: the signal that its update needs a
    stochastic-rounding key."""
    if state.tables[aname].dtype in (torch.bfloat16, torch.int8):
        return True
    return any(t.dtype == torch.bfloat16 for t in state.slots[aname])


def _copy_into(dst, src) -> None:
    """Copy a tensor tree (dicts, lists, tuples) into ``dst``'s tensors."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            _copy_into(v, src[k])
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src):
            _copy_into(a, b)
    else:
        dst.copy_(src)


@dataclass
class SparseTrainState:
    """Dense backbone under AdamW + embedding tables under a sparse
    optimizer.  ``step`` counts applied steps on the host."""

    step: int
    backbone: torch.nn.Module
    optimizer: torch.optim.Optimizer
    tables: dict[str, torch.Tensor]
    slots: dict[str, Any]
    sparse_opt: SparseOptimizer

    @classmethod
    def create(cls, *, backbone, tables, sparse_opt, learning_rate: float,
               weight_decay: float) -> "SparseTrainState":
        return cls(
            step=0,
            backbone=backbone,
            optimizer=make_adamw(backbone.parameters(), learning_rate,
                                 weight_decay),
            tables=dict(tables),
            # int8 sidecars are storage, not optimized parameters
            slots={n: (() if n.startswith(QSCALE_PREFIX) else sparse_opt.init(t))
                   for n, t in tables.items()},
            sparse_opt=sparse_opt,
        )

    def state_dict(self) -> dict:
        """The tensor-dict form ``train/checkpoint.py`` saves: ``step`` (the
        stochastic-rounding keys fold it, so it comes back exactly), the
        backbone, AdamW's tensors, the tables (int8 sidecars included) and
        their slots (update caches included, as dicts)."""
        return {
            "step": self.step,
            "backbone": dict(self.backbone.state_dict()),
            "optimizer": optimizer_tensors(self.optimizer),
            "tables": dict(self.tables),
            "slots": {k: (dict(v) if isinstance(v, dict) else list(v))
                      for k, v in self.slots.items()},
        }

    def load_state_dict(self, tree: dict) -> None:
        """Copy a :meth:`state_dict` form into the live tensors."""
        self.step = int(tree["step"])
        with torch.no_grad():
            for k, v in self.backbone.state_dict().items():
                v.copy_(tree["backbone"][k])
            load_optimizer_tensors(self.optimizer, tree["optimizer"])
            for k, v in tree["tables"].items():
                self.tables[k].copy_(v)
            for k, v in tree["slots"].items():
                _copy_into(self.slots[k], v)

    def snapshot(self) -> dict:
        """Device copy of everything a step mutates (the non-finite guard's
        rollback point)."""
        return clone_tree(self.state_dict())

    def restore(self, snap: dict) -> None:
        """Copy a :meth:`snapshot` back into the live tensors (the snapshot
        itself stays usable for a later rollback)."""
        self.load_state_dict(snap)


def make_sparse_train_step(coll: ShardedEmbeddingCollection,
                           forward: Callable, *, mode: str = "gspmd",
                           with_aux: bool = False,
                           dedup_lookup: bool = False,
                           batch_transform: Callable | None = None,
                           tensor_parallel: bool = False):
    """Build the step ``(state, batch, generator=None) -> (state, loss)``
    (``(state, (loss, aux))`` with ``with_aux``); ``forward(embs, batch)``
    returns the loss (or ``(loss, aux)``).  A forward that also takes a
    ``generator`` keyword receives the step's ``torch.Generator`` (the
    reference's ``dropout_rng``; ``None`` disables dropout), and one that
    takes ``batch_group`` the step's :class:`BatchGroup` (a loss whose
    divisor depends on the data, the masked LM's label count, normalises
    over the whole group with it).  ``batch``
    holds an id tensor, of any shape, for every feature the collection
    serves (``[B]`` CTR ids, ``[B, T]`` item sequences), after
    ``batch_transform`` (run first, on the device: the jagged path's
    ``(values, lengths) -> [B, T]``).  Returned losses are detached device
    tensors: reading one is the caller's (only) host sync.
    ``tensor_parallel``: the forward is a Megatron backbone whose model
    ranks must see the same rows; under ``alltoall`` each rank's looked-up
    share is gathered over the model axis before it (see
    :func:`_build_step`)."""
    bg, train = _build_step(coll, forward, mode=mode, with_aux=with_aux,
                            dedup_lookup=dedup_lookup,
                            tensor_parallel=tensor_parallel)

    def step(state: SparseTrainState, batch, generator=None):
        if batch_transform is not None:
            batch = batch_transform(batch)
        return train(state, bg.split(batch), generator)

    return step


def _build_step(coll: ShardedEmbeddingCollection, forward: Callable, *,
                mode: str, with_aux: bool, dedup_lookup: bool,
                tensor_parallel: bool = False):
    """``(batch group, train)``: ``train(state, share, generator=None,
    grouped_ctx=None)`` runs one step on this rank's share of a
    (transformed) batch; ``grouped_ctx`` is the grouped exchange's
    input-dist of that share when the caller issued it already.

    Tensor parallelism under ``alltoall``: the lookup and the sparse update
    run on this rank's share (the batch group, data x model), but the
    Megatron forward needs the data-local batch on every model rank.  So
    the share's rows and looked-up vectors are gathered over the model axis
    before the forward (``SeqGather``: its backward keeps this rank's block
    of the gradient, which every model rank holds whole after the
    backbone's own reductions), and the loss, the dense gradients, the
    dropout share and the masked-LM count follow the data axis alone, as
    under ``gspmd``."""
    if mode not in ("gspmd", "psum", "alltoall"):
        raise ValueError(f"unknown lookup mode {mode!r}")
    if dedup_lookup and mode != "gspmd":
        raise ValueError("dedup_lookup composes with lookup mode 'gspmd' only")
    if coll.cache_rows > 0 and mode != "gspmd":
        raise ValueError(
            "the update cache (cache_rows > 0) composes with lookup mode "
            "'gspmd' only")
    bg = BatchGroup(coll.mesh, mode)
    # the forward's group: the data axis alone when a Megatron backbone
    # must see every model rank's share
    fg = (BatchGroup(coll.mesh, "gspmd") if tensor_parallel and bg.model_split
          else bg)
    features = list(coll.features())
    takes_gen = "generator" in inspect.signature(forward).parameters
    takes_group = "batch_group" in inspect.signature(forward).parameters
    hot_tables = coll.hot_tables()
    if hot_tables and mode != "gspmd":
        raise ValueError("hot/cold tables compose with lookup mode 'gspmd' only")
    feat_table = {f: coll.resolve(f)[1].name for f in features}
    hot_by_table = {t: [f for f in features if feat_table[f] == t]
                    for t in hot_tables}
    hot_feats = {f for t in hot_tables for f in hot_by_table[t]}
    # features of fully hot tables have no cold side: no cold gather,
    # dedupe or update
    full_hot_feats = {f for f in hot_feats if coll.hot_full(feat_table[f])}
    # the grouped exchange carries every row/table-sharded feature, both
    # ways; the per-array path below keeps the rest
    grouped_feats = (tuple(coll.grouped_features(dict.fromkeys(features)))
                     if mode == "alltoall" else ())
    grouped_arrays = sorted({coll.resolve(f)[0] for f in grouped_feats})
    rest_feats = [f for f in features if f not in grouped_feats]
    by_table: dict[str, list[str]] = {}
    for f in rest_feats:
        if f not in full_hot_feats:
            by_table.setdefault(coll.resolve(f)[0], []).append(f)
    # the per-array update's features, and the hot features, in one order
    # on every rank (the batch group gathers their ids and grads)
    up = [f for f in rest_feats if f not in full_hot_feats]
    hot_list = [f for f in features if f in hot_feats]
    column = {a for a in by_table
              if a in coll.specs and coll.specs[a].sharding == "column"}
    # column shards under a mesh: each rank holds (and caches) its columns
    col_split = {a for a in column if coll.array_placement(a) == "column"}

    def _concat_ids(feats, ids, rows_per_line: int = 1):
        """Stacked ids of ``feats`` (offsets added), per-feature sizes, and
        the static distinct bound: rows (minus the hot head's rows, which
        never reach the cold side), or with ``rows_per_line`` > 1 LINES (+1
        per feature: a member may straddle one extra line at an unaligned
        stack offset)."""
        id_list, sizes, bound = [], [], 0
        for f in feats:
            _, spec, offset = coll.resolve(f)
            i = ids[f].to(torch.int64)
            # negative (padding or routed-to-hot) ids stay negative: an
            # offset would alias them into the previous stack member's rows
            flat = torch.where(i >= 0, i + offset, torch.full_like(i, -1)).reshape(-1)
            id_list.append(flat)
            sizes.append(flat.shape[0])
            if rows_per_line == 1:
                cold_rows = spec.num_embeddings - coll.hot_count(spec.name)
                bound += min(flat.shape[0], cold_rows)
            else:
                bound += min(flat.shape[0],
                             -(-spec.num_embeddings // rows_per_line) + 1)
        return torch.cat(id_list), sizes, bound

    def train(state: SparseTrainState, batch, generator=None, grouped_ctx=None):
        ids = {f: batch[f] for f in features}
        # the cache is on when the state carries coll.init_caches's entries
        cached = {k[len(CACHE_PREFIX):] for k in state.slots
                  if k.startswith(CACHE_PREFIX)}
        hot_pos: dict[str, torch.Tensor] = {}
        cold_ids = dict(ids)
        for f in hot_list:
            hot_pos[f], cold_ids[f] = coll.route_ids(f, ids[f])
        # the global batch's cold ids and head positions, in its order (one
        # gather), for the dedupe and the updates
        g_cold, g_hot = cold_ids, hot_pos
        if bg.size > 1 and (up or hot_list):
            parts = bg.gather([cold_ids[f].reshape(-1).to(torch.int64) for f in up]
                              + [hot_pos[f].reshape(-1).to(torch.int64)
                                 for f in hot_list])
            g_cold = dict(cold_ids, **dict(zip(up, parts[:len(up)])))
            g_hot = dict(zip(hot_list, parts[len(up):]))

        def merge_hot(f, cold_vec):
            """The hot head's rows at hot hits (identity off hot/cold)."""
            hp = hot_pos.get(f)
            if hp is None:
                return cold_vec
            hot = state.tables[coll.hot_array_name(feat_table[f])]
            hot_vec = hot[torch.clamp(hp.to(torch.int64), min=0)].to(torch.float32)
            if cold_vec is None:  # fully hot: no cold side
                return hot_vec
            return torch.where((hp >= 0)[..., None], hot_vec, cold_vec)

        def overlay_lookup(embs, feats):
            """Serve cached rows into ``coll.lookup``'s vectors, at the row
            each position's gather read (the reference's clamp rule), so
            the vector equals the uncached path's."""
            for f in feats:
                aname, _, off = coll.resolve(f)
                if aname not in cached or f in full_hot_feats:
                    continue
                cache = state.slots[CACHE_PREFIX + aname]
                hp = hot_pos.get(f)
                if hp is None:
                    v = coll.array_rows(aname)
                    gid = torch.clamp(ids[f].to(torch.int64) + off, 0, v - 1)
                else:
                    cold = cold_ids[f].to(torch.int64)
                    gid = torch.where(cold >= 0, cold + off, 0)
                cur, hit = cache_lookup_rows(cache, gid)
                if aname in col_split:  # the cached columns, whole rows
                    cur = all_gather_cat(cur, coll._model_group(), dim=-1)
                if hp is not None:
                    hit = hit & (hp < 0)
                embs[f] = torch.where(hit[..., None], cur.to(embs[f].dtype), embs[f])
            return embs

        def dedup_forward():
            """The dedup lookup over the global batch's ids: ``(embs,
            ctx)`` with ``ctx[array]`` the routing its update reuses
            (column arrays take the default lookup and have none)."""
            embs, ctx = {}, {}
            for aname, feats in by_table.items():
                if aname in column:
                    embs.update(overlay_lookup(coll.lookup(
                        state.tables, {f: ids[f] for f in feats}, mode=mode),
                        feats))
                    continue
                table = state.tables[aname]
                d = coll.array_embedding_dim(aname)
                split = coll.split_rows(aname)
                all_ids, sizes, bound = _concat_ids(feats, g_cold)
                obs_counters.emit(f"emb/{aname}/touched_ids",
                                  lambda a=all_ids: (a >= 0).sum())
                total = all_ids.shape[0]
                # +1: negative ids dedupe to ONE sentinel slot past the bound
                cap = -(-(bound + 1) // 8) * 8 if bound + 1 < total else None
                if table.dim() == 3 and split is None:
                    lay = coll.fat_layout_for(aname)
                    _, _, bound_l = _concat_ids(feats, g_cold,
                                                rows_per_line=lay.r)
                    cap_r = cap if cap is not None else total
                    cap_l = min(cap_r, -(-(bound_l + 1) // 8) * 8)
                    seg, ulines, row_lidx, row_slot, plan = dedupe_rows_and_lines(
                        all_ids, capacity_rows=cap_r, capacity_lines=cap_l,
                        rows_per_line=lay.r, with_plan=True)
                    # whole lines (sentinel -> line 0), then each distinct
                    # row's slot: the sentinel row reads row 0, as the
                    # default lookup; int8 lines take the codes and their
                    # sidecar bytes and decode the small block
                    lidx = torch.where(ulines < SENTINEL, ulines, 0)
                    lines = (table[lidx.to(torch.int64)]
                             if table.dtype == torch.int8
                             else take_fill(table, lidx)).contiguous()
                    pick = (torch.clamp(row_lidx.to(torch.int64), max=cap_l - 1)
                            * lay.r + row_slot)
                    span = d + 8 if lay.dtype == "int8" else d
                    rows = lines.view(cap_l * lay.r, lay.w)[pick, :span]
                    if lay.dtype == "int8":
                        rows = dequantize_rows(rows[:, :d],
                                               bytes_to_f32(rows[:, d:span]))
                    ctx[aname] = ("routed", ulines, seg, plan, row_lidx,
                                  row_slot, lines)
                    obs_counters.emit(f"emb/{aname}/unique_lines",
                                      lambda u=ulines: (u < SENTINEL).sum())
                else:
                    uids, seg, valid, plan = dedupe_ids(
                        all_ids, capacity=cap, max_distinct=cap, with_plan=True)
                    gid = torch.where(valid, uids.to(torch.int64), 0)
                    if split is not None:
                        # each rank's own distinct rows, summed over the
                        # model axis (the gspmd program)
                        rows = coll._lookup_psum(state.tables, aname,
                                                 coll.resolve(feats[0])[1], gid,
                                                 fill=True)
                    elif coll.array_is_int8(aname):
                        rows = dequantize_rows(
                            table[gid], state.tables[qscale_name(aname)][gid])
                    else:
                        rows = take_fill(table, gid)
                    if aname in cached:
                        # sentinel slots read row 0, and so overlay row 0
                        rows = cache_overlay_rows(
                            state.slots[CACHE_PREFIX + aname], gid, rows)
                    # a fat shard takes the default sharded update
                    ctx[aname] = (("sharded",) if table.dim() == 3
                                  else ("rows", uids, seg, plan, valid))
                    obs_counters.emit(f"emb/{aname}/unique_rows",
                                      lambda v=valid: v.sum())
                rows = rows.to(torch.float32)
                off = 0
                for f, n_f in zip(feats, sizes):
                    # this rank's positions of the feature's global ids
                    n = n_f // bg.size
                    e = take_fill(rows, seg[off + bg.index * n:off + (bg.index + 1) * n])
                    embs[f] = merge_hot(f, e.reshape(*ids[f].shape, e.shape[-1]))
                    off += n_f
            for f in full_hot_feats:
                embs[f] = merge_hot(f, None)
            return embs, ctx

        with torch.no_grad():
            if dedup_lookup:
                gathered, ctx = dedup_forward()
            elif grouped_feats:
                gathered = coll.grouped_lookup(
                    state.tables, {f: ids[f] for f in grouped_feats}, grouped_ctx)
                if rest_feats:
                    gathered.update(coll.lookup(
                        state.tables, {f: ids[f] for f in rest_feats}, mode=mode))
                ctx = {}
            else:
                # coll.lookup routes hot/cold itself
                gathered = overlay_lookup(
                    coll.lookup(state.tables, ids, mode=mode), features)
                ctx = {}
        embs = {f: v.requires_grad_(True) for f, v in gathered.items()}
        kw = {"generator": fg.share(generator)} if takes_gen else {}
        if takes_group:
            kw["batch_group"] = fg
        if fg is bg:
            out = forward(embs, batch, **kw)
        else:  # the data-local batch on every model rank
            mg = axis_group(coll.mesh, MODEL_AXIS)
            out = forward({f: SeqGather.apply(v, mg, 0) for f, v in embs.items()},
                          {k: all_gather_cat(v, mg) for k, v in batch.items()},
                          **kw)
        loss, aux = out if with_aux else (out, None)
        params = list(state.backbone.parameters())
        # the forward group's mean: each rank's share weighs 1 / G
        loss_g = loss if fg.size == 1 else loss / fg.size
        grads = torch.autograd.grad(loss_g, params + [embs[f] for f in features])
        dense = list(grads[:len(params)])
        if fg.size > 1:
            dense = all_reduce_tensors(dense, fg.group)
        if obs_counters.enabled():
            # the reference's global norms: the dense half's gradients (the
            # global batch's, after the reduction) and the looked-up rows'
            # (each rank holds its share of the batch's); param_norm reads
            # the whole tables (one pass over them, paid only with counters
            # on).  What a mesh splits over the model axis (tensor-parallel
            # parameters, row and column shards) sums over it.
            mg = model_group(coll.mesh)
            split = model_split([n for n, _ in state.backbone.named_parameters()],
                                getattr(state.backbone, "tp_plan", None))
            tsplit = {a: coll.array_placement(a) != "replicated"
                      for a in state.tables}
            obs_counters.emit("grad_norm", _global_norm(
                [g for g, sp in zip(dense, split) if not sp],
                ([g for g, sp in zip(dense, split) if sp], mg),
                (list(grads[len(params):]), bg.group)))
            obs_counters.emit("param_norm", _global_norm(
                [p for p, sp in zip(params, split) if not sp]
                + [t for a, t in state.tables.items() if not tsplit[a]],
                ([p for p, sp in zip(params, split) if sp]
                 + [t for a, t in state.tables.items() if tsplit[a]], mg)))
        for p, g in zip(params, dense):
            p.grad = g
        state.optimizer.step()
        for p in params:
            p.grad = None
        g_embs = dict(zip(features, grads[len(params):]))
        if bg.size > 1 and rest_feats:
            # the global batch's row grads, in its order: one gather per
            # (dim, dtype) (the grouped features send theirs to the owners
            # instead)
            by_kind: dict = {}
            for f in rest_feats:
                g = g_embs[f]
                by_kind.setdefault((g.shape[-1], g.dtype), []).append(f)
            for fs in by_kind.values():
                for f, v in zip(fs, bg.gather([g_embs[f].reshape(-1, g_embs[f].shape[-1])
                                               for f in fs])):
                    g_embs[f] = v
        opt = state.sparse_opt

        def _sr_key(aname):
            return (_make_sr_key(state.step, aname)
                    if _array_is_narrow(state, aname) else None)

        def qscale_of(aname):
            """A plain int8 array's sidecar (fat int8 carries it in-line)."""
            return state.tables.get(qscale_name(aname))

        with torch.no_grad():
            if grouped_feats:
                narrow = any(_array_is_narrow(state, a) for a in grouped_arrays)
                coll.grouped_update(
                    opt, state.tables, state.slots,
                    {f: ids[f] for f in grouped_feats},
                    {f: g_embs[f] for f in grouped_feats},
                    sr_key=(_make_sr_key(state.step, "__grouped_update__")
                            if narrow else None))
            for aname, feats in by_table.items():
                table = state.tables[aname]
                ck = CACHE_PREFIX + aname
                all_grads = torch.cat([g_embs[f].reshape(-1, g_embs[f].shape[-1])
                                       for f in feats]).to(torch.float32)
                # small plain adam arrays keep the raw-id dense tier (int8
                # ones then take update's row path, never the dense sweep)
                small_adam = (opt.kind == "adam" and table.dim() == 2
                              and coll.array_rows(aname) <= opt.small_vocab_threshold)
                if aname in ctx and not small_adam and ctx[aname][0] != "sharded":
                    # shared dedupe: segment-sum by the forward's seg
                    c = ctx[aname]
                    d = coll.array_embedding_dim(aname)
                    if c[0] == "routed":
                        _, ulines, seg, plan, row_lidx, row_slot, lines = c
                        g_u = _segment_sum(all_grads, seg, row_lidx.shape[0],
                                           plan)
                        opt.update_routed(
                            table, state.slots[aname], ulines, g_u, row_lidx,
                            row_slot, lines, embedding_dim=d,
                            sr_key=_sr_key(aname))
                        continue
                    _, uids, seg, plan, valid = c
                    g_u = _segment_sum(all_grads, seg, uids.shape[0], plan)
                    g_u = torch.where(valid[:, None], g_u, 0.0)
                    if aname in cached:
                        # the cached tier: the table and its slots are
                        # read, never written, until the flush
                        with obs_counters.scope(f"emb/{aname}/"):
                            state.slots[ck], _ = opt.cache_update_unique(
                                state.slots[ck], table, state.slots[aname],
                                uids, g_u, valid, step=state.step,
                                sr_key=_sr_key(aname), qscale=qscale_of(aname),
                                gather=coll.owner_gather(aname))
                        continue
                    coll.update_unique(opt, aname, table, state.slots[aname],
                                       uids, g_u, valid, sr_key=_sr_key(aname),
                                       qscale=qscale_of(aname))
                    continue
                all_ids, _, bound = _concat_ids(feats, g_cold)
                obs_counters.emit(f"emb/{aname}/touched_ids",
                                  lambda a=all_ids: (a >= 0).sum())
                # dedupe capacity = the proven distinct bound when tighter
                # than the id count (reference ``_concat_ids``)
                md = -(-bound // 8) * 8 if bound < all_ids.shape[0] else None
                if aname in cached and not small_adam:
                    key, kw = _sr_key(aname), {}
                    if aname in col_split:
                        all_grads, key = coll.column_share(all_grads, key)
                        kw["row_sq_mean"] = coll._whole_row_sq_mean
                    with obs_counters.scope(f"emb/{aname}/"):
                        state.slots[ck], _ = opt.cache_update(
                            state.slots[ck], table, state.slots[aname],
                            all_ids, all_grads, step=state.step, capacity=md,
                            max_distinct=md, sr_key=key,
                            qscale=qscale_of(aname),
                            gather=coll.owner_gather(aname),
                            vocab_rows=coll.array_rows(aname), **kw)
                    continue
                coll.sparse_update(
                    opt, aname, table, state.slots[aname], all_ids, all_grads,
                    max_distinct=md, sr_key=_sr_key(aname),
                    qscale=qscale_of(aname))
            # hot heads: one segment sum and one dense [K, D] step per table
            for tname in hot_tables:
                hname = coll.hot_array_name(tname)
                feats = hot_by_table[tname]
                hp_all = torch.cat([g_hot[f].reshape(-1) for f in feats])
                obs_counters.emit(f"emb/{tname}/hot_ids",
                                  lambda h=hp_all: (h >= 0).sum())
                g_all = torch.cat([g_embs[f].reshape(-1, g_embs[f].shape[-1])
                                   for f in feats])
                opt.dense_update(state.tables[hname], state.slots[hname],
                                 hp_all, g_all, sr_key=_sr_key(hname))
        state.step += 1
        loss = fg.mean(loss.detach())
        return state, ((loss, fg.join(aux.detach())) if with_aux else loss)

    return bg, train


class PipelinedSparseStep(NamedTuple):
    """The three entry points of the pipelined sparse step (reference
    ``PipelinedSparseStep``).  ``prime(batch) -> carry`` runs the input-dist
    of the epoch's first batch and trains nothing; ``step(state, batch,
    carry, generator=None) -> (state, out, carry)`` issues the NEW batch's
    input-dist, then trains the CARRIED one; ``flush(state, carry,
    generator=None) -> (state, out)`` trains the last carried batch.
    ``carry`` is ``(batch, ctx)``: the transformed data-local batch (the
    train AUC reads its labels) and its share's input-dist, whose id
    exchange may still be in flight.  A checkpoint need not keep it: on
    resume the stream re-yields the carried batch and ``prime`` rebuilds
    the ctx from its ids."""

    prime: Callable
    step: Callable
    flush: Callable


def make_pipelined_sparse_train_step(coll: ShardedEmbeddingCollection,
                                     forward: Callable, *,
                                     with_aux: bool = False,
                                     batch_transform: Callable | None = None,
                                     tensor_parallel: bool = False):
    """The cross-batch pipelined step over the grouped exchange (reference
    ``make_pipelined_sparse_train_step``, torchrec
    ``TrainPipelineSparseDist``): the grouped input-dist reads no table, so
    ``step`` starts batch N+1's id ``all_to_all`` (``async_op``) before it
    runs batch N's lookup, forward, backward and update, and waits on it
    only when batch N+1 trains, one call later.  Losses, generators (by
    ``state.step``, which counts trained batches) and the state evolve
    exactly as under the eager grouped step; outputs surface one call
    later.  Requires a ``grouped_a2a`` collection under a mesh; hot/cold
    tables and the update cache (both ``gspmd``-only) refuse, as does
    ``dedup_lookup`` (in the trainer).  Features of replicated tables keep
    their per-array path inside the step."""
    if not (coll.grouped_a2a and coll.mesh is not None):
        raise ValueError(
            "the pipelined sparse step requires a grouped_a2a collection on "
            "a device mesh ([embeddings] grouped_a2a = true with "
            "model_parallel)")
    if coll.hot_tables():
        raise ValueError(
            "hot/cold tables do not compose with the pipelined sparse step "
            "(they require lookup mode 'gspmd')")
    if coll.cache_rows > 0:
        raise ValueError(
            "the update cache (cache_rows > 0) does not compose with the "
            "pipelined sparse step (it requires lookup mode 'gspmd')")
    bg, train = _build_step(coll, forward, mode="alltoall", with_aux=with_aux,
                            dedup_lookup=False, tensor_parallel=tensor_parallel)
    grouped_feats = tuple(coll.grouped_features(dict.fromkeys(coll.features())))

    def prime(batch):
        if batch_transform is not None:
            batch = batch_transform(batch)
        share = bg.split(batch)
        return batch, coll.grouped_input_dist(
            {f: share[f] for f in grouped_feats}, async_op=True)

    def step(state, batch, carry, generator=None):
        # the new batch's id exchange first: it reads no table, so it runs
        # while the carried batch trains
        new_carry = prime(batch)
        state, out = flush(state, carry, generator)
        return state, out, new_carry

    def flush(state, carry, generator=None):
        batch, ctx = carry
        return train(state, bg.split(batch), generator, grouped_ctx=ctx)

    return PipelinedSparseStep(prime=prime, step=step, flush=flush)


def make_cache_flush_fn(coll: ShardedEmbeddingCollection | None = None):
    """The update cache's write-back: ``flush(state) -> (state,
    overflow)``.  Per cached array it bit-copies every dirty row and its
    mirrors into the table and slots (int8: codes and sidecar), evicts
    down to the hottest half and returns the interval's admission-overflow
    count (``overflow``: array name -> 0-dim device tensor).  A non-zero
    count means lost updates; the caller must fail.  A state without
    caches flushes to itself.  ``coll``: the state's collection, needed
    under a mesh, where each rank writes only the rows its shards own (the
    replicated caches evict alike on every rank)."""

    def flush(state: SparseTrainState):
        overflow = {}
        with torch.no_grad():
            for key in sorted(state.slots):
                if not key.startswith(CACHE_PREFIX):
                    continue
                aname = key[len(CACHE_PREFIX):]
                qs = state.tables.get(qscale_name(aname))
                with obs_counters.scope(f"emb/{aname}/"):
                    out = state.sparse_opt.cache_flush(
                        state.slots[key], state.tables[aname],
                        state.slots[aname], qscale=qs,
                        owned=None if coll is None else coll.owned_rows(aname))
                state.slots[key], overflow[aname] = out[0], out[-1]
        return state, overflow

    return flush
