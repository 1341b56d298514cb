"""Hybrid sparse/dense train step — port of the eager, non-dedup branch of
``tdfo_tpu/train/sparse_step.py::make_sparse_train_step``.

torchrec's DMP + CombinedOptimizer split, in PyTorch: the collection
gathers the rows a batch touches; ``torch.autograd.grad`` takes the loss
gradient with respect to the dense parameters and the GATHERED rows (never
a ``[V, d]`` table); AdamW steps the dense half; then every table array gets
one row-sparse update (``ops/sparse.py`` tiers — the fat-line tables go
through the ``fat_line_update`` kernel).  Tables and slots update in place.

Only ``mode = "gspmd"`` without ``dedup_lookup`` is ported; the dedup
lookup, the grouped exchange, hot/cold tables, the update cache and the
pipelined step raise ``NotImplementedError`` naming their ``ROADMAP.md``
item.
"""

from __future__ import annotations

import copy
import inspect
from dataclasses import dataclass
from typing import Any, Callable

import torch

from tdfo_tpu_torch.ops.sparse import SparseOptimizer
from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection
from tdfo_tpu_torch.train.state import make_adamw

__all__ = ["SparseTrainState", "make_sparse_train_step"]


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

    def snapshot(self) -> dict:
        """Deep copy of everything a step mutates (device copies; the
        non-finite guard's rollback point)."""
        return {
            "step": self.step,
            "backbone": copy.deepcopy(self.backbone.state_dict()),
            "optimizer": copy.deepcopy(self.optimizer.state_dict()),
            "tables": {k: v.clone() for k, v in self.tables.items()},
            "slots": {k: tuple(s.clone() for s in v)
                      for k, v in self.slots.items()},
        }

    def restore(self, snap: dict) -> None:
        """Copy a :meth:`snapshot` back into the live tensors (the snapshot
        itself stays usable for a later rollback)."""
        self.step = snap["step"]
        self.backbone.load_state_dict(snap["backbone"])
        self.optimizer.load_state_dict(copy.deepcopy(snap["optimizer"]))
        for k, v in snap["tables"].items():
            self.tables[k].copy_(v)
        for k, v in snap["slots"].items():
            for dst, src in zip(self.slots[k], v):
                dst.copy_(src)


def make_sparse_train_step(coll: ShardedEmbeddingCollection,
                           forward: Callable, *, mode: str = "gspmd",
                           with_aux: bool = False,
                           dedup_lookup: bool = False):
    """Build the step ``(state, batch, generator=None) -> (state, loss)``
    (``(state, (loss, aux))`` with ``with_aux``); ``forward(embs, batch)``
    returns the loss (or ``(loss, aux)``).  A forward that also takes a
    ``generator`` keyword receives the step's ``torch.Generator`` (the
    reference's ``dropout_rng``; ``None`` disables dropout).  ``batch``
    holds an id tensor, of any shape, for every feature the collection
    serves (``[B]`` CTR ids, ``[B, T]`` item sequences).  Returned losses are
    detached device tensors: reading one is the caller's (only) host
    sync."""
    if mode != "gspmd":
        raise NotImplementedError(
            f"lookup mode {mode!r} is not ported yet (ROADMAP.md Queue A "
            "item 12)")
    if dedup_lookup:
        raise NotImplementedError(
            "dedup_lookup is not ported yet (ROADMAP.md Queue A item 10)")
    features = list(coll.features())
    takes_gen = "generator" in inspect.signature(forward).parameters
    by_table: dict[str, list[str]] = {}
    for f in features:
        by_table.setdefault(coll.resolve(f)[0], []).append(f)

    def _concat_ids(feats, ids):
        id_list, bound = [], 0
        for f in feats:
            _, spec, offset = coll.resolve(f)
            i = ids[f].to(torch.int64)
            # negative (padding) ids stay negative: an offset would alias
            # them into the previous stack member's rows
            flat = torch.where(i >= 0, i + offset, torch.full_like(i, -1)).reshape(-1)
            id_list.append(flat)
            bound += min(flat.shape[0], spec.num_embeddings)
        return torch.cat(id_list), bound

    def step(state: SparseTrainState, batch, generator=None):
        ids = {f: batch[f] for f in features}
        with torch.no_grad():
            gathered = coll.lookup(state.tables, ids, mode=mode)
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
        with torch.no_grad():
            for aname, feats in by_table.items():
                all_ids, bound = _concat_ids(feats, ids)
                all_grads = torch.cat([g_embs[f].reshape(-1, g_embs[f].shape[-1])
                                       for f in feats])
                # dedupe capacity = the proven distinct bound when tighter
                # than the id count (reference ``_concat_ids``)
                md = -(-bound // 8) * 8 if bound < all_ids.shape[0] else None
                state.tables[aname], state.slots[aname] = coll.sparse_update(
                    state.sparse_opt, aname, state.tables[aname],
                    state.slots[aname], all_ids, all_grads, max_distinct=md)
        state.step += 1
        loss = loss.detach()
        return state, ((loss, aux.detach()) if with_aux else loss)

    return step
