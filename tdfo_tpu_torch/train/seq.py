"""Sequential-recommendation training — port of ``tdfo_tpu/train/seq.py``
(``masked_ce_loss``, ``score_candidates``, ``bert4rec_sparse_forward``).

* loss: cross-entropy over the vocab at every position, PAD labels ignored,
  label smoothing 0.1, mean over the non-PAD positions (0, not NaN, for a
  batch without labels).  ``F.cross_entropy(label_smoothing=s)`` computes
  the reference's ``(1 - s) * CE(onehot) + s * mean(-log p)`` in one fused
  call, without a second ``[B, T, V]`` log-probability tensor.
* eval: score the last position against the candidate ids (column 0 the
  positive).
* dropout: each step draws from its own ``torch.Generator``,
  :func:`dropout_generator` of ``(seed, step)`` (the reference's
  ``fold_in(dropout_rng, state.step)``), so the masks are a function of the
  saved state: a resumed run, or a chunk of ``steps_per_execution``
  steps, draws what the uninterrupted run draws.

``bert4rec_loss_fn`` is the loss of the self-contained ``Bert4Rec`` under
``train.step.make_train_step`` (every parameter under AdamW).
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from tdfo_tpu_torch.models.bert4rec import PAD_ID, key_padding_mask

__all__ = ["masked_ce_loss", "score_candidates", "bert4rec_loss_fn",
           "bert4rec_sparse_forward", "dropout_generator"]


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of step ``step``: seeded with the 64 bits of
    ``threefry fold_in(PRNGKey(seed), step)`` (``ops/threefry.py``)."""
    from tdfo_tpu_torch.ops.threefry import PRNGKey, fold_in

    hi, lo = fold_in(PRNGKey(seed), step)
    return torch.Generator(device=device).manual_seed((int(hi) << 32) | int(lo))


def masked_ce_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                   pad_id: int = PAD_ID,
                   label_smoothing: float = 0.1) -> torch.Tensor:
    """Mean smoothed CE over non-PAD positions; ``logits [B, T, V]``,
    ``labels [B, T]``."""
    v = logits.shape[-1]
    labels = labels.reshape(-1).to(torch.int64)
    total = F.cross_entropy(logits.reshape(-1, v).to(torch.float32), labels,
                            ignore_index=pad_id,
                            label_smoothing=label_smoothing, reduction="sum")
    count = (labels != pad_id).sum().to(torch.float32)
    return total / count.clamp_min(1.0)


def score_candidates(logits: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """``[B, T, V]`` logits, ``[B, C]`` candidate ids -> ``[B, C]`` scores at
    the last position."""
    return torch.gather(logits[:, -1, :], 1, candidates.to(torch.int64))


def bert4rec_loss_fn(model, batch, *, generator=None,
                     label_smoothing: float = 0.1):
    """``make_train_step``'s ``loss_fn`` for ``Bert4Rec``: ``batch`` holds
    ``item`` (masked input ids) and ``label`` ([B, T]); ``generator``
    enables dropout.  Returns ``(loss, logits)``."""
    logits = model(batch["item"], generator=generator)
    return masked_ce_loss(logits, batch["label"],
                          label_smoothing=label_smoothing), logits


def bert4rec_sparse_forward(backbone, *, label_smoothing: float = 0.1):
    """Forward for ``make_sparse_train_step``: the collection has gathered
    the item vectors; run the backbone and the masked CE.  The step passes
    its dropout ``generator`` through (``None``: no dropout)."""

    def forward(embs, batch, generator=None):
        logits = backbone(embs["item"], key_padding_mask(batch["item"]),
                          generator=generator)
        return masked_ce_loss(logits, batch["label"],
                              label_smoothing=label_smoothing)

    return forward
