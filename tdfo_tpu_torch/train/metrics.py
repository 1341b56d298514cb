"""Evaluation metrics — port of ``binary_auc``, ``ranking_auc``, ``AUC``
and ``recalls_and_ndcgs_for_ks`` from ``tdfo_tpu/train/metrics.py``.

* :func:`binary_auc` — exact ROC-AUC (Mann-Whitney U, tie-aware), host-side
  numpy; copied unchanged.
* :func:`ranking_auc` — per-row AUC of ``[N, C]`` candidate panels
  (column 0 the positive), the serving fleet's heartbeat for sequence
  bundles; copied unchanged.
* :class:`AUC` — streaming thresholded ROC-AUC (``tf.keras.metrics.AUC``
  parity, 200 bins): per-class histograms of sigmoid scores kept as tensors
  on the scores' device, so folding a batch never syncs to the host.
* :func:`recalls_and_ndcgs_for_ks` — sampled-candidate Recall@k / NDCG@k
  (Bert4Rec eval); the top-k takes the lower candidate index first on tied
  scores, as ``jax.lax.top_k`` does (a stable descending sort: ``torch.topk``
  promises no order among ties).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tdfo_tpu_torch.ops.kernels.segment_sum import segment_sum

__all__ = ["binary_auc", "ranking_auc", "AUC", "recalls_and_ndcgs_for_ks"]


def binary_auc(labels, scores, weights=None) -> float:
    """Exact ROC-AUC via the Mann-Whitney U statistic with tie handling.
    ``weights`` masks padded eval rows (weight 0 = padding)."""
    labels = np.asarray(labels).reshape(-1).astype(np.float64)
    scores = np.asarray(scores).reshape(-1).astype(np.float64)
    if weights is not None:
        keep = np.asarray(weights).reshape(-1) > 0
        labels, scores = labels[keep], scores[keep]
    pos = scores[labels > 0.5]
    neg = scores[labels <= 0.5]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    neg_sorted = np.sort(neg)
    below = np.searchsorted(neg_sorted, pos, side="left")
    below_or_eq = np.searchsorted(neg_sorted, pos, side="right")
    u = below.sum() + 0.5 * (below_or_eq - below).sum()
    return float(u / (len(pos) * len(neg)))


def ranking_auc(scores) -> float:
    """AUC over sampled-candidate panels: ``scores`` is [N, C] with column 0
    the positive and columns 1.. the negatives.  Per row, the positive is
    ranked against its own negatives (win 1, tie 0.5) and rows average, so
    per-user score-scale shifts cannot move it."""
    s = np.asarray(scores, np.float64)
    if s.ndim != 2 or s.shape[1] < 2:
        raise ValueError(
            f"ranking_auc needs [N, C>=2] candidate panels, got {s.shape}")
    pos, neg = s[:, :1], s[:, 1:]
    wins = (pos > neg).sum(axis=1) + 0.5 * (pos == neg).sum(axis=1)
    return float(np.mean(wins / neg.shape[1]))


@dataclass(frozen=True)
class AUC:
    """Streaming thresholded ROC-AUC: histograms of probabilities per class
    over ``num_thresholds`` equal-width bins in [0, 1]; ``result``
    integrates the ROC curve by trapezoid (ties within a bin count half)."""

    pos_hist: torch.Tensor  # [num_thresholds] weighted positive counts per bin
    neg_hist: torch.Tensor  # [num_thresholds]

    @classmethod
    def empty(cls, num_thresholds: int = 200, device="cpu") -> "AUC":
        z = torch.zeros((num_thresholds,), dtype=torch.float32, device=device)
        return cls(pos_hist=z, neg_hist=z.clone())

    @property
    def num_thresholds(self) -> int:
        return self.pos_hist.shape[0]

    def update(self, labels, scores, weights=None) -> "AUC":
        """Accumulate a batch of probabilities ``scores`` in [0, 1];
        ``weights`` zero out padded rows."""
        n = self.num_thresholds
        labels = labels.reshape(-1).to(torch.float32)
        scores = scores.reshape(-1)
        w = (torch.ones_like(labels) if weights is None
             else weights.reshape(-1).to(torch.float32))
        bins = torch.clamp((scores * n).to(torch.int64), 0, n - 1)
        pos = segment_sum(w * labels, bins, n)
        neg = segment_sum(w * (1.0 - labels), bins, n)
        return AUC(pos_hist=self.pos_hist + pos, neg_hist=self.neg_hist + neg)

    def merge(self, other: "AUC") -> "AUC":
        return AUC(self.pos_hist + other.pos_hist, self.neg_hist + other.neg_hist)

    def result(self) -> torch.Tensor:
        total_pos = self.pos_hist.sum()
        total_neg = self.neg_hist.sum()
        neg_above = torch.flip(torch.cumsum(torch.flip(self.neg_hist, (0,)), 0),
                               (0,)) - self.neg_hist
        neg_below = total_neg - neg_above - self.neg_hist
        u = torch.sum(self.pos_hist * (neg_below + 0.5 * self.neg_hist))
        ok = (total_pos > 0) & (total_neg > 0)
        val = u / torch.clamp(total_pos * total_neg, min=1.0)
        return torch.where(ok, val, torch.full_like(val, float("nan")))


def recalls_and_ndcgs_for_ks(scores: torch.Tensor, labels: torch.Tensor,
                             ks: tuple[int, ...] = (10, 20, 50),
                             row_weights: torch.Tensor | None = None,
                             ) -> dict[str, torch.Tensor]:
    """Recall@k = hits in the top k / min(k, positives); NDCG@k with the
    1/log2(rank + 2) gain.  ``scores``/``labels`` ``[B, C]``;
    ``row_weights`` masks padded rows; returns weighted batch means as
    0-d tensors on the scores' device."""
    b, c = scores.shape
    w = (torch.ones((b,), dtype=torch.float32, device=scores.device)
         if row_weights is None else row_weights.to(torch.float32))
    denom = w.sum().clamp_min(1.0)
    labels = labels.to(torch.float32)
    n_pos = labels.sum(dim=1)
    k_max = min(max(ks), c)  # k past the candidate count ranks all of them
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    hit = torch.gather(labels, 1, order[:, :k_max])
    positions = torch.arange(k_max, dtype=torch.float32, device=scores.device)
    gains = 1.0 / torch.log2(positions + 2.0)
    out: dict[str, torch.Tensor] = {}
    for k in ks:
        kk = min(k, c)
        hits_k = hit[:, :kk]
        recall = hits_k.sum(dim=1) / torch.clamp(
            torch.clamp(n_pos, max=float(kk)), min=1.0)
        dcg = (hits_k * gains[:kk]).sum(dim=1)
        ideal = (positions[:kk][None, :] < n_pos[:, None]).to(torch.float32)
        idcg = (ideal * gains[:kk]).sum(dim=1)
        ndcg = dcg / idcg.clamp_min(1e-9)
        out[f"Recall@{k}"] = (recall * w).sum() / denom
        out[f"NDCG@{k}"] = (ndcg * w).sum() / denom
    return out
