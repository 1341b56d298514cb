"""Train state and the dense optimizer — port of ``tdfo_tpu/train/state.py``.

``make_adamw``: optax ``adamw(lr, weight_decay=wd)`` maps to
``torch.optim.AdamW`` with the same betas, eps and decoupled weight decay on
every parameter: the same math, rounded in another order (``p *= 1 -
lr*wd`` first, then the Adam step), which the port's trajectory tolerance
covers.  Its moments are made when the optimizer is made (optax's
``tx.init``), not at the first step, so a fresh state has every tensor a
checkpoint holds.  ``capturable=True`` keeps the step counter on the card,
the form a CUDA graph can replay.

:class:`TrainState` is the dense regime's state (the whole ``TwoTower``,
tables included, under AdamW), with ``step`` and the optional f16
``DynamicLossScale``.  Its tensor-dict form (:meth:`TrainState.state_dict`,
``load_state_dict``) is what ``train/checkpoint.py`` saves and the
non-finite guard snapshots; loading copies into the live tensors, so a
captured CUDA graph keeps reading the same memory.  The DMP regime's state
is ``train/sparse_step.py::SparseTrainState``, with the same form.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from tdfo_tpu_torch.core.precision import DynamicLossScale

__all__ = ["TrainState", "clone_tree", "load_optimizer_tensors", "make_adamw",
           "optimizer_tensors"]


def make_adamw(params, learning_rate: float, weight_decay: float, *,
               capturable: bool = False) -> torch.optim.AdamW:
    params = list(params)
    opt = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay,
                            capturable=capturable)
    for p in params:  # torch's own lazy init, done now
        step = (torch.zeros((), dtype=torch.float32, device=p.device)
                if capturable else torch.tensor(0.0, dtype=torch.float32))
        opt.state[p] = {"step": step,
                        "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                        "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}
    return opt


def optimizer_tensors(opt: torch.optim.Optimizer) -> dict[int, dict[str, torch.Tensor]]:
    """The optimizer's per-parameter state by parameter index (its
    hyperparameters come from the config, as optax's ``tx`` does)."""
    params = [p for g in opt.param_groups for p in g["params"]]
    return {i: dict(opt.state[p]) for i, p in enumerate(params)}


def load_optimizer_tensors(opt: torch.optim.Optimizer, tree) -> None:
    """Copy :func:`optimizer_tensors`' form back into the live state (the
    step counter may arrive in either form: a CPU scalar or a card one)."""
    params = [p for g in opt.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        for k, v in tree[i].items():
            opt.state[p][k].copy_(v)


def clone_tree(tree: Any) -> Any:
    """Deep copy of a tensor-dict form (fresh device tensors, ints kept)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


@dataclass
class TrainState:
    """Dense regime: ``model`` (every parameter, tables included) under
    ``optimizer`` (AdamW); ``step`` counts applied steps on the host."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    loss_scale: DynamicLossScale | None = None

    @classmethod
    def create(cls, *, model: torch.nn.Module, learning_rate: float,
               weight_decay: float, loss_scale: DynamicLossScale | None = None,
               capturable: bool = False) -> "TrainState":
        return cls(step=0, model=model,
                   optimizer=make_adamw(model.parameters(), learning_rate,
                                        weight_decay, capturable=capturable),
                   loss_scale=loss_scale)

    def state_dict(self) -> dict:
        out = {"step": self.step, "params": dict(self.model.state_dict()),
               "optimizer": optimizer_tensors(self.optimizer)}
        if self.loss_scale is not None:
            out["loss_scale"] = {"scale": self.loss_scale.scale,
                                 "growth_counter": self.loss_scale.growth_counter}
        return out

    def load_state_dict(self, tree: dict) -> None:
        self.step = int(tree["step"])
        with torch.no_grad():
            for k, v in self.model.state_dict().items():
                v.copy_(tree["params"][k])
            load_optimizer_tensors(self.optimizer, tree["optimizer"])
            if self.loss_scale is not None:
                self.loss_scale.scale.copy_(tree["loss_scale"]["scale"])
                self.loss_scale.growth_counter.copy_(
                    tree["loss_scale"]["growth_counter"])

    def snapshot(self) -> dict:
        """A device copy of the tensor-dict form (the non-finite guard's
        rollback point)."""
        return clone_tree(self.state_dict())

    def restore(self, snap: dict) -> None:
        """Copy a :meth:`snapshot` back into the live tensors (the snapshot
        stays usable for a later rollback)."""
        self.load_state_dict(snap)
