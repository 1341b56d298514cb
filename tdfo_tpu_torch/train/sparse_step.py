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

Narrow storage: every array whose table or optimizer slot is stored in
bf16 gets a stochastic-rounding key per step, ``ops.quant.sr_key(step,
array name)`` (reference ``_sr_key``), derived on the host from
``state.step``; f32 arrays get None, so their update is what it was.  The
gathered rows widen to f32 before the model sees them.

Only ``mode = "gspmd"`` is ported; the grouped exchange, hot/cold tables,
the update cache and the pipelined step are not ported yet (``ROADMAP.md``
Queue A items 12 and 13).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, Callable

import torch

from tdfo_tpu_torch.ops.kernels.fat_line_update import SENTINEL
from tdfo_tpu_torch.ops.quant import sr_key as _make_sr_key
from tdfo_tpu_torch.ops.sparse import (
    SparseOptimizer,
    _segment_sum,
    dedupe_ids,
    dedupe_rows_and_lines,
)
from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection, take_fill
from tdfo_tpu_torch.train.state import (
    clone_tree,
    load_optimizer_tensors,
    make_adamw,
    optimizer_tensors,
)

__all__ = ["SparseTrainState", "make_sparse_train_step"]


def _array_is_narrow(state: "SparseTrainState", aname: str) -> bool:
    """True when ``aname``'s table or any floating optimizer slot is stored
    in bf16: the signal that its update needs a stochastic-rounding key."""
    if state.tables[aname].dtype == torch.bfloat16:
        return True
    return any(t.dtype == torch.bfloat16 for t in state.slots[aname])


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
            slots={n: sparse_opt.init(t) for n, t in tables.items()},
            sparse_opt=sparse_opt,
        )

    def state_dict(self) -> dict:
        """The tensor-dict form ``train/checkpoint.py`` saves: ``step`` (the
        stochastic-rounding keys fold it, so it comes back exactly), the
        backbone, AdamW's tensors, the tables and their slots."""
        return {
            "step": self.step,
            "backbone": dict(self.backbone.state_dict()),
            "optimizer": optimizer_tensors(self.optimizer),
            "tables": dict(self.tables),
            "slots": {k: list(v) for k, v in self.slots.items()},
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
                for dst, src in zip(self.slots[k], v):
                    dst.copy_(src)

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
                           batch_transform: Callable | None = None):
    """Build the step ``(state, batch, generator=None) -> (state, loss)``
    (``(state, (loss, aux))`` with ``with_aux``); ``forward(embs, batch)``
    returns the loss (or ``(loss, aux)``).  A forward that also takes a
    ``generator`` keyword receives the step's ``torch.Generator`` (the
    reference's ``dropout_rng``; ``None`` disables dropout).  ``batch``
    holds an id tensor, of any shape, for every feature the collection
    serves (``[B]`` CTR ids, ``[B, T]`` item sequences), after
    ``batch_transform`` (run first, on the device: the jagged path's
    ``(values, lengths) -> [B, T]``).  Returned losses are detached device
    tensors: reading one is the caller's (only) host sync."""
    if mode != "gspmd":
        raise NotImplementedError(
            f"lookup mode {mode!r} is not ported yet (ROADMAP.md Queue A "
            "item 12)")
    features = list(coll.features())
    takes_gen = "generator" in inspect.signature(forward).parameters
    by_table: dict[str, list[str]] = {}
    for f in features:
        by_table.setdefault(coll.resolve(f)[0], []).append(f)

    def _concat_ids(feats, ids, rows_per_line: int = 1):
        """Stacked ids of ``feats`` (offsets added), per-feature sizes, and
        the static distinct bound: rows, or with ``rows_per_line`` > 1
        LINES (+1 per feature: a member may straddle one extra line at an
        unaligned stack offset)."""
        id_list, sizes, bound = [], [], 0
        for f in feats:
            _, spec, offset = coll.resolve(f)
            i = ids[f].to(torch.int64)
            # negative (padding) ids stay negative: an offset would alias
            # them into the previous stack member's rows
            flat = torch.where(i >= 0, i + offset, torch.full_like(i, -1)).reshape(-1)
            id_list.append(flat)
            sizes.append(flat.shape[0])
            if rows_per_line == 1:
                bound += min(flat.shape[0], spec.num_embeddings)
            else:
                bound += min(flat.shape[0],
                             -(-spec.num_embeddings // rows_per_line) + 1)
        return torch.cat(id_list), sizes, bound

    def _dedup_forward(tables, ids):
        """The dedup lookup: ``(embs, ctx)`` with ``ctx[array]`` the
        routing its update reuses."""
        embs, ctx = {}, {}
        for aname, feats in by_table.items():
            table = tables[aname]
            all_ids, sizes, bound = _concat_ids(feats, ids)
            total = all_ids.shape[0]
            # +1: negative ids dedupe to ONE sentinel slot past the bound
            cap = -(-(bound + 1) // 8) * 8 if bound + 1 < total else None
            if table.dim() == 3:
                lay = coll.fat_layout_for(aname)
                _, _, bound_l = _concat_ids(feats, ids, rows_per_line=lay.r)
                cap_r = cap if cap is not None else total
                cap_l = min(cap_r, -(-(bound_l + 1) // 8) * 8)
                seg, ulines, row_lidx, row_slot = dedupe_rows_and_lines(
                    all_ids, capacity_rows=cap_r, capacity_lines=cap_l,
                    rows_per_line=lay.r)
                # whole lines (sentinel -> line 0), then each distinct row's
                # slot: the sentinel row reads row 0, as the default lookup
                lines = take_fill(table, torch.where(
                    ulines < SENTINEL, ulines, 0)).contiguous()
                pick = (torch.clamp(row_lidx.to(torch.int64), max=cap_l - 1)
                        * lay.r + row_slot)
                rows = lines.view(cap_l * lay.r, lay.w)[pick, :lay.d]
                ctx[aname] = ("routed", ulines, seg, row_lidx, row_slot, lines)
            else:
                uids, seg, valid = dedupe_ids(all_ids, capacity=cap,
                                              max_distinct=cap)
                rows = take_fill(table, torch.where(valid, uids.to(torch.int64), 0))
                ctx[aname] = ("rows", uids, seg, valid)
            off = 0
            for f, n_f in zip(feats, sizes):
                e = take_fill(rows, seg[off:off + n_f]).to(torch.float32)
                embs[f] = e.reshape(*ids[f].shape, e.shape[-1])
                off += n_f
        return embs, ctx

    def step(state: SparseTrainState, batch, generator=None):
        if batch_transform is not None:
            batch = batch_transform(batch)
        ids = {f: batch[f] for f in features}
        with torch.no_grad():
            if dedup_lookup:
                gathered, ctx = _dedup_forward(state.tables, ids)
            else:
                gathered, ctx = coll.lookup(state.tables, ids, mode=mode), {}
        embs = {f: v.requires_grad_(True) for f, v in gathered.items()}
        out = (forward(embs, batch, generator=generator) if takes_gen
               else forward(embs, batch))
        loss, aux = out if with_aux else (out, None)
        params = list(state.backbone.parameters())
        grads = torch.autograd.grad(loss, params + [embs[f] for f in features])
        for p, g in zip(params, grads[:len(params)]):
            p.grad = g
        state.optimizer.step()
        for p in params:
            p.grad = None
        g_embs = dict(zip(features, grads[len(params):]))
        opt = state.sparse_opt

        def _sr_key(aname):
            return (_make_sr_key(state.step, aname)
                    if _array_is_narrow(state, aname) else None)

        with torch.no_grad():
            for aname, feats in by_table.items():
                table = state.tables[aname]
                all_grads = torch.cat([g_embs[f].reshape(-1, g_embs[f].shape[-1])
                                       for f in feats]).to(torch.float32)
                # small plain adam arrays keep the raw-id dense tier
                small_adam = (opt.kind == "adam" and table.dim() == 2
                              and table.shape[0] <= opt.small_vocab_threshold)
                if aname in ctx and not small_adam:
                    # shared dedupe: segment-sum by the forward's seg
                    c = ctx[aname]
                    d = coll.array_embedding_dim(aname)
                    if c[0] == "routed":
                        _, ulines, seg, row_lidx, row_slot, lines = c
                        g_u = _segment_sum(all_grads, seg, row_lidx.shape[0])
                        state.tables[aname], state.slots[aname] = opt.update_routed(
                            table, state.slots[aname], ulines, g_u, row_lidx,
                            row_slot, lines, embedding_dim=d,
                            sr_key=_sr_key(aname))
                    else:
                        _, uids, seg, valid = c
                        g_u = _segment_sum(all_grads, seg, uids.shape[0])
                        g_u = torch.where(valid[:, None], g_u, 0.0)
                        state.tables[aname], state.slots[aname] = opt.update_unique(
                            table, state.slots[aname], uids, g_u, valid,
                            embedding_dim=d, sr_key=_sr_key(aname))
                    continue
                all_ids, _, bound = _concat_ids(feats, ids)
                # dedupe capacity = the proven distinct bound when tighter
                # than the id count (reference ``_concat_ids``)
                md = -(-bound // 8) * 8 if bound < all_ids.shape[0] else None
                state.tables[aname], state.slots[aname] = coll.sparse_update(
                    opt, aname, table, state.slots[aname], all_ids, all_grads,
                    max_distinct=md, sr_key=_sr_key(aname))
        state.step += 1
        loss = loss.detach()
        return state, ((loss, aux.detach()) if with_aux else loss)

    return step
