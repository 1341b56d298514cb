"""Sequential-recommendation training — port of ``tdfo_tpu/train/seq.py``
(``masked_ce_loss``, ``score_candidates``, ``bert4rec_sparse_forward``).

* loss: cross-entropy over the vocab at every position, PAD labels ignored,
  label smoothing 0.1, mean over the non-PAD positions (0, not NaN, for a
  batch without labels).  ``F.cross_entropy(label_smoothing=s)`` computes
  the reference's ``(1 - s) * CE(onehot) + s * mean(-log p)`` in one fused
  call, without a second ``[B, T, V]`` log-probability tensor.
* eval: score the last position against the candidate ids (column 0 the
  positive).
* a vocab split over the model axis (``vocab_split``, the backbone's
  ``vocab_tp`` under Megatron tensor parallelism: each rank holds its
  ``V / M`` columns of the logits): the loss all-reduces each row's max,
  sum of exponentials, target logit and sum of logits over the model
  group, keeping the reference's smoothing ``(1 - s) CE + s mean(-log
  p)`` over the global V; its backward is local (each rank's columns of
  ``softmax - (1 - s) onehot - s / V``).  Candidate scores: each rank
  gathers the ids in its columns, and the ranks' results are summed.
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


def _split_sum(x: torch.Tensor, split) -> torch.Tensor:
    """In-place sum of ``x`` over ``split.group`` (a ``ModelSplit`` or a
    ``BatchGroup``)."""
    import torch.distributed as dist

    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=split.group)
    return x


class _VocabParallelCE(torch.autograd.Function):
    """Per-row smoothed CE of logits split by columns over ``split``'s
    group: ``z [N, V / M]`` f32 (this rank's columns), ``labels [N]``
    global ids.  Returns ``[N]``, the same on every rank."""

    @staticmethod
    def forward(ctx, z, labels, smoothing, split, v_total):
        import torch.distributed as dist

        vl = z.shape[-1]
        m = z.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=split.group)
        e = torch.exp(z - m[:, None])
        local = labels - split.index * vl
        inside = (local >= 0) & (local < vl)
        pick = torch.clamp(local, 0, vl - 1)
        zt = torch.where(inside, z.gather(1, pick[:, None])[:, 0], 0.0)
        sums = _split_sum(torch.stack((e.sum(dim=-1), zt, z.sum(dim=-1))), split)
        lse = m + torch.log(sums[0])
        loss = ((1.0 - smoothing) * (lse - sums[1])
                + smoothing * (lse - sums[2] / v_total))
        ctx.save_for_backward(e, sums[0], pick, inside)
        ctx.smoothing, ctx.v_total = smoothing, v_total
        return loss

    @staticmethod
    def backward(ctx, g):
        e, se, pick, inside = ctx.saved_tensors
        s = ctx.smoothing
        grad = e / se[:, None] - s / ctx.v_total
        grad.scatter_add_(1, pick[:, None],
                          torch.where(inside, -(1.0 - s), 0.0)[:, None])
        return grad * g[:, None], None, None, None, None


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of step ``step``: seeded with the 64 bits of
    ``threefry fold_in(PRNGKey(seed), step)`` (``ops/threefry.py``)."""
    from tdfo_tpu_torch.ops.threefry import PRNGKey, fold_in

    hi, lo = fold_in(PRNGKey(seed), step)
    return torch.Generator(device=device).manual_seed((int(hi) << 32) | int(lo))


def masked_ce_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                   pad_id: int = PAD_ID, label_smoothing: float = 0.1,
                   vocab_split=None, batch_group=None) -> torch.Tensor:
    """Mean smoothed CE over non-PAD positions; ``logits [B, T, V]``
    (``[B, T, V / M]``, this rank's columns, under ``vocab_split``, a
    ``models.transformer.ModelSplit``), ``labels [B, T]``.  Under a
    ``batch_group`` (``train.sparse_step.BatchGroup``, its G ranks holding
    shares of the global batch) the divisor is the global batch's count
    of labels over G: the step's mean over the group is then the global
    batch's mean, however the labels fall between the shares."""
    v = logits.shape[-1]
    labels = labels.reshape(-1).to(torch.int64)
    keep = labels != pad_id
    count = keep.sum().to(torch.float32).clamp_min(1.0)
    if batch_group is not None and batch_group.size > 1:
        count = (_split_sum(keep.sum().to(torch.float32), batch_group)
                 .clamp_min(1.0) / batch_group.size)
    if vocab_split is None:
        total = F.cross_entropy(logits.reshape(-1, v).to(torch.float32), labels,
                                ignore_index=pad_id,
                                label_smoothing=label_smoothing, reduction="sum")
    else:
        per_row = _VocabParallelCE.apply(
            logits.reshape(-1, v).to(torch.float32), labels,
            float(label_smoothing), vocab_split, v * vocab_split.size)
        total = torch.where(keep, per_row, 0.0).sum()
    return total / count


def score_candidates(logits: torch.Tensor, candidates: torch.Tensor,
                     vocab_split=None) -> torch.Tensor:
    """``[B, T, V]`` logits, ``[B, C]`` candidate ids -> ``[B, C]`` scores at
    the last position (``vocab_split``: the logits are this rank's
    columns; each rank scores the ids in them, and the ranks' results are
    summed)."""
    last = logits[:, -1, :]
    cands = candidates.to(torch.int64)
    if vocab_split is None:
        return torch.gather(last, 1, cands)
    vl = last.shape[-1]
    local = cands - vocab_split.index * vl
    inside = (local >= 0) & (local < vl)
    got = torch.gather(last, 1, torch.clamp(local, 0, vl - 1))
    return _split_sum(torch.where(inside, got, 0.0).contiguous(), vocab_split)


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
    its dropout ``generator`` and its ``batch_group`` through (``None``:
    no dropout; one device)."""

    def forward(embs, batch, generator=None, batch_group=None):
        logits = backbone(embs["item"], key_padding_mask(batch["item"]),
                          generator=generator)
        return masked_ce_loss(logits, batch["label"],
                              label_smoothing=label_smoothing,
                              vocab_split=getattr(backbone, "vocab_tp", None),
                              batch_group=batch_group)

    return forward
