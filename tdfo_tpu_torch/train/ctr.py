"""CTR training in the DMP regime — port of ``tdfo_tpu/train/ctr.py``.

The tables live in a ShardedEmbeddingCollection and get row-sparse updates
(``train/sparse_step.py``); the dense backbone runs under AdamW.
"""

from __future__ import annotations

from typing import Callable

import torch

from tdfo_tpu_torch.train.step import bce_with_logits_loss

__all__ = ["ctr_sparse_forward", "make_ctr_sparse_eval_step"]


def ctr_sparse_forward(backbone, with_logits: bool = False) -> Callable:
    """Forward for ``make_sparse_train_step``: ``(embs, batch) -> loss``
    (or ``(loss, logits)`` with ``with_logits``) — the backbone over the
    gathered vectors, then the sigmoid BCE."""

    def forward(embs, batch):
        logits = backbone(embs, batch)
        loss = bce_with_logits_loss(logits, batch["label"].to(torch.float32))
        return (loss, logits) if with_logits else loss

    return forward


def make_ctr_sparse_eval_step(coll, backbone, *, mode: str = "gspmd"):
    """``(state, batch) -> (loss, logits)`` without autograd; under a mesh
    ``batch`` is the rank's data slice and the logits are that slice's
    (an ``alltoall`` lookup splits it over the model axis and the logits
    are gathered back), the loss its share's."""
    from tdfo_tpu_torch.train.sparse_step import BatchGroup

    features = list(coll.features())
    bg = BatchGroup(coll.mesh, mode)

    @torch.no_grad()
    def step(state, batch):
        batch = bg.split(batch)
        embs = coll.lookup(state.tables, {f: batch[f] for f in features},
                           mode=mode)
        logits = backbone(embs, batch)
        loss = bce_with_logits_loss(logits, batch["label"].to(torch.float32))
        return loss, bg.join(logits)

    return step
