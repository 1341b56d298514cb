"""Loss — port of ``tdfo_tpu/train/step.py::bce_with_logits_loss``.

The dense-regime ``make_train_step`` / ``make_eval_step`` / multi-step loop
of the reference are not ported yet (``ROADMAP.md`` Queue A items 4 and 8).
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

__all__ = ["bce_with_logits_loss"]


def bce_with_logits_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy on logits (optax
    ``sigmoid_binary_cross_entropy(...).mean()`` parity)."""
    return F.binary_cross_entropy_with_logits(logits, labels.to(logits.dtype))
