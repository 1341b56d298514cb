"""Train and eval steps of the dense regime — port of
``tdfo_tpu/train/step.py`` (``bce_with_logits_loss``, ``make_train_step``,
``make_multi_step``, ``make_eval_step``).

``make_train_step`` takes the loss gradient of every parameter of the
state's model (tables included), steps AdamW and, under f16
``mixed_precision``, scales the loss and keeps the old parameters and
optimizer state where a gradient overflowed (the reference's non-finite
rollback, with ``torch.where`` in place of a branch: no host sync).

``steps_per_execution = K`` (the reference's one-dispatch ``lax.scan``):
:func:`make_multi_step` runs a stacked ``[K, B, ...]`` chunk as K steps and
keeps the K losses on the device.  On the card, :class:`CudaGraphStep`
captures the dense step once over static batch buffers and each step of a
chunk is one graph replay; a capture that fails raises.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.nn import functional as F

from tdfo_tpu_torch.core.precision import scale_loss, unscale_grads

__all__ = ["CudaGraphStep", "bce_with_logits_loss", "make_eval_step",
           "make_multi_step", "make_train_step"]


def bce_with_logits_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy on logits (optax
    ``sigmoid_binary_cross_entropy(...).mean()`` parity).  Narrow logits
    (a bf16/f16 compute dtype) take optax's formula: ``log_sigmoid`` in the
    logits' dtype, then the f32 labels promote the loss to f32."""
    if logits.dtype == torch.float32:
        return F.binary_cross_entropy_with_logits(logits, labels.to(logits.dtype))
    labels = labels.to(torch.float32)
    log_p = F.logsigmoid(logits).to(torch.float32)
    log_not_p = F.logsigmoid(-logits).to(torch.float32)
    return (-labels * log_p - (1.0 - labels) * log_not_p).mean()


def _default_loss(model, batch):
    logits = model(batch)
    return bce_with_logits_loss(logits, batch["label"].to(torch.float32)), logits


def make_train_step(loss_fn: Callable | None = None, *, with_aux: bool = False):
    """``step(state, batch) -> (state, loss)`` (``(state, (loss, aux))``
    with ``with_aux``) for a :class:`~tdfo_tpu_torch.train.state.TrainState`.
    ``loss_fn(model, batch)`` returns ``(loss, aux)``; the default is the
    sigmoid BCE on ``batch["label"]`` with the logits as aux.  The state
    updates in place; returned tensors are detached device tensors."""
    loss_fn = loss_fn or _default_loss

    def step(state, batch):
        loss, aux = loss_fn(state.model, batch)
        params = list(state.model.parameters())
        ls = state.loss_scale
        grads = torch.autograd.grad(scale_loss(loss, ls), params)
        grads, finite = unscale_grads(grads, ls)
        opt = state.optimizer
        kept = None
        if ls is not None:  # overflow: keep the old parameters and moments
            kept = [(t, t.detach().clone()) for p in params
                    for t in (p, *opt.state[p].values())]
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        for p in params:
            p.grad = None
        if ls is not None:
            with torch.no_grad():
                for t, old in kept:
                    t.copy_(torch.where(finite, t, old))
                new = ls.update(finite)
                ls.scale.copy_(new.scale)
                ls.growth_counter.copy_(new.growth_counter)
        state.step += 1
        loss = loss.detach()
        return state, ((loss, aux.detach()) if with_aux else loss)

    return step


def make_multi_step(step_fn: Callable):
    """``multi(state, stack) -> (state, losses [K])``: ``step_fn(state,
    batch) -> (state, loss)`` over the K batches of a stacked chunk in
    order (a short tail chunk is fine), the losses kept on the device."""

    def multi(state, stack):
        k = next(iter(stack.values())).shape[0]
        losses = []
        for i in range(k):
            state, loss = step_fn(state, {n: v[i] for n, v in stack.items()})
            losses.append(loss)
        return state, torch.stack(losses)

    return multi


def make_eval_step():
    """``step(state, batch) -> (loss, logits)`` without autograd."""

    @torch.no_grad()
    def step(state, batch):
        logits = state.model(batch)
        return bce_with_logits_loss(logits, batch["label"].to(torch.float32)), logits

    return step


_WARMUP = 3  # eager steps before a capture (autograd and cuBLAS set-up)


class CudaGraphStep:
    """A step ``(state, batch) -> (state, out)`` replayed from a CUDA graph.

    The first call warms the step up on a side stream (``_WARMUP`` steps,
    which the capture needs), captures one step over static copies of the
    batch, and puts the state back to what it was before the warm-up (the
    state's tensors are copied into, never replaced, so the graph keeps
    reading them).  Every call then copies the batch into the static
    buffers, replays the graph, advances ``state.step`` and returns clones
    of the outputs.  The state's optimizer must be capturable.  A capture
    that fails raises: nothing falls back to eager steps."""

    def __init__(self, step_fn: Callable):
        self.step_fn = step_fn
        self.graph = None
        self._static_in: dict[str, torch.Tensor] = {}
        self._static_out = None

    def _capture(self, state, batch) -> None:
        if any(v.device.type != "cuda" for v in batch.values()):
            raise ValueError("CudaGraphStep needs a batch on the card")
        snap = state.snapshot()
        self._static_in = {k: v.clone() for k, v in batch.items()}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(_WARMUP):
                self.step_fn(state, self._static_in)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _, self._static_out = self.step_fn(state, self._static_in)
        state.restore(snap)  # undo the warm-up steps
        self.graph = graph

    def __call__(self, state, batch):
        if self.graph is None:
            self._capture(state, batch)
        for k, v in batch.items():
            self._static_in[k].copy_(v)
        self.graph.replay()
        state.step += 1
        out = self._static_out
        if isinstance(out, tuple):
            return state, tuple(t.clone() for t in out)
        return state, out.clone()
