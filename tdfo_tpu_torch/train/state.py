"""Dense optimizer — port of ``tdfo_tpu/train/state.py::make_adamw``.

optax ``adamw(lr, weight_decay=wd)`` maps to ``torch.optim.AdamW`` with the
same betas, eps and decoupled weight decay on every parameter: the same
math, rounded in another order (``p *= 1 - lr*wd`` first, then the Adam
step), which the port's trajectory tolerance covers.  The dense-regime
``TrainState`` is not ported yet (``ROADMAP.md`` Queue A item 4); the
sparse regime's state is ``train/sparse_step.py::SparseTrainState``.
"""

from __future__ import annotations

import torch

__all__ = ["make_adamw"]


def make_adamw(params, learning_rate: float,
               weight_decay: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)
