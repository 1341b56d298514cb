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
chunk is one graph replay; a capture that fails raises.  Under several
ranks the graph holds the step's collectives (the data all-reduce of the
gradients and of the loss, and the PS partition's all-gathers), which only
NCCL can capture: the warm-up steps create its communicators before the
capture, and several ranks under another backend refuse.

Data parallelism (``make_train_step(mesh=...)``): each rank steps on its
data slice; the loss is divided by the data axis size D before the
backward and the gradients are summed over the data axis (the global
batch's mean), so every replica applies the same update; the returned loss
is the global mean.  At D = 1 nothing changes.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.nn import functional as F

from tdfo_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, axis_group, axis_size
from tdfo_tpu_torch.core.precision import scale_loss, unscale_grads
from tdfo_tpu_torch.obs import counters as obs_counters
from tdfo_tpu_torch.parallel.collectives import all_reduce_, all_reduce_tensors

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


def global_norm(tensors, *split) -> torch.Tensor:
    """``optax.global_norm``: the 2-norm of all elements, in f32, of
    ``tensors`` and of the tensors a mesh splits over ranks: each of
    ``split`` is ``(blocks, group)``, this rank's blocks of tensors split
    over ``group`` (None: one rank), whose squares sum over it.  Every rank
    gets the norm of the whole state."""
    def norms(ts):
        return [torch.linalg.vector_norm(t.detach().to(torch.float32)) for t in ts]

    parts = norms(tensors)
    for blocks, group in split:
        if blocks:
            sq = torch.stack(norms(blocks)).square().sum()
            if group is not None:
                sq = all_reduce_(sq, group)
            parts.append(sq.sqrt())
    return torch.linalg.vector_norm(torch.stack(parts))


def model_split(names, plan) -> list[bool]:
    """Which of the parameters ``names`` ``plan`` (parameter -> placement,
    as ``parallel.sharding.shard_module_`` returns it) splits over the
    model axis."""
    plan = plan or {}
    return [MODEL_AXIS in plan.get(n, ()) for n in names]


def model_group(mesh):
    """The model axis's group of this rank (None at one model rank)."""
    return axis_group(mesh, MODEL_AXIS) if axis_size(mesh, MODEL_AXIS) > 1 else None


def _default_loss(model, batch):
    logits = model(batch)
    return bce_with_logits_loss(logits, batch["label"].to(torch.float32)), logits


def make_train_step(loss_fn: Callable | None = None, *, with_aux: bool = False,
                    mesh=None, plan=None):
    """``step(state, batch) -> (state, loss)`` (``(state, (loss, aux))``
    with ``with_aux``) for a :class:`~tdfo_tpu_torch.train.state.TrainState`.
    ``loss_fn(model, batch)`` returns ``(loss, aux)``; the default is the
    sigmoid BCE on ``batch["label"]`` with the logits as aux.  The state
    updates in place; returned tensors are detached device tensors.
    ``mesh``: data-parallel over its data axis (the module note); ``aux``
    stays the rank's.  ``plan``: the PS partition's (parameter ->
    placement), whose split parameters the counters' norms sum over the
    model axis."""
    loss_fn = loss_fn or _default_loss
    n_data = axis_size(mesh, DATA_AXIS)
    group = axis_group(mesh, DATA_AXIS) if n_data > 1 else None

    def step(state, batch):
        loss, aux = loss_fn(state.model, batch)
        params = list(state.model.parameters())
        ls = state.loss_scale
        grads = torch.autograd.grad(
            scale_loss(loss if group is None else loss / n_data, ls), params)
        if group is not None:
            grads = all_reduce_tensors(grads, group)
        grads, finite = unscale_grads(grads, ls)
        if obs_counters.enabled():
            # the whole model's norms: the split parameters' blocks (and
            # their gradients' slices) summed over the model axis
            split = model_split([n for n, _ in state.model.named_parameters()], plan)
            mg = model_group(mesh)
            for name, ts in (("grad_norm", grads), ("param_norm", params)):
                obs_counters.emit(name, global_norm(
                    [t for t, s in zip(ts, split) if not s],
                    ([t for t, s in zip(ts, split) if s], mg)))
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
        if group is not None:
            loss = all_reduce_(loss.clone(), group) / n_data
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
    that fails raises: nothing falls back to eager steps.  Several ranks
    need NCCL (the module note)."""

    def __init__(self, step_fn: Callable):
        import torch.distributed as dist

        if (dist.is_initialized() and dist.get_world_size() > 1
                and dist.get_backend() != "nccl"):
            raise ValueError(
                "CUDA-graph steps need NCCL: the "
                f"{dist.get_backend()} backend's collectives run on the host "
                "and cannot be captured")
        self.step_fn = step_fn
        self.graph = None
        self._static_in: dict[str, torch.Tensor] = {}
        self._static_out = None

    def _capture(self, state, batch) -> None:
        from tdfo_tpu_torch.obs import events as _events
        from tdfo_tpu_torch.obs import trace as _trace

        if any(v.device.type != "cuda" for v in batch.values()):
            raise ValueError("CudaGraphStep needs a batch on the card")
        t0 = _trace.clock()
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
        _events.compiled("cuda_graph:train_step", _trace.elapsed_s(t0))

    def __call__(self, state, batch):
        if self.graph is None:
            self._capture(state, batch)
        for k, v in batch.items():
            self._static_in[k].copy_(v)
        self.graph.replay()
        state.step += 1
        return state, _clone_out(self._static_out)


def _clone_out(out):
    """Fresh copies of a step's outputs (tensors in tuples and dicts: the
    loss, its aux, and a counters dict) so a later replay cannot overwrite
    what a caller holds."""
    if isinstance(out, tuple):
        return tuple(_clone_out(t) for t in out)
    if isinstance(out, dict):
        return {k: _clone_out(v) for k, v in out.items()}
    return out.clone()
