"""Placement rules for named state — port of ``tdfo_tpu/parallel/sharding.py``
(``rowwise_embedding_rule``, ``min_size_partitioner_rule``,
``make_sharding_plan``, ``shard_state``).

A rule maps ``(path, leaf)`` to a placement or ``None`` (no match); a
placement is a tuple with one entry per dimension, an axis name where that
dimension is split over the mesh axis and ``None`` where it is whole (the
reference's ``PartitionSpec``); ``()`` is replicated.  Paths are the
reference's ``/``-joined keys, leaves torch tensors or numpy arrays.
:func:`make_sharding_plan` gives every leaf the first matching rule's
placement; :func:`shard_state` keeps this rank's block of each leaf (there
is no GSPMD to place it: the rank holds its block and the program that
reads it does the communication).

``megatron_tp_rule`` places the transformer's dense layers for Megatron
tensor parallelism; :func:`module_plan` applies a plan to a port module's
parameters (torch layout: a ``Linear`` weight is the transposed kernel).
:func:`ps_shard_module_` is the dense regime's PS partition: each split
parameter held as this rank's block, all-gathered whole for every forward.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping

from tdfo_tpu_torch.core.mesh import MODEL_AXIS, axis_index, axis_size

__all__ = ["PlanRule", "make_sharding_plan", "megatron_tp_rule",
           "min_size_partitioner_rule", "module_flax_paths", "module_plan",
           "ps_shard_module_", "rowwise_embedding_rule", "shard_module_",
           "shard_state"]

PlanRule = Callable[[str, Any], "tuple | None"]


def _nbytes(leaf) -> int:
    if hasattr(leaf, "element_size"):  # a torch tensor
        return leaf.numel() * leaf.element_size()
    return int(leaf.nbytes)


def rowwise_embedding_rule(mesh, pattern: str = r"embed",
                           min_rows: int | None = None,
                           axis: str = MODEL_AXIS) -> PlanRule:
    """Row-wise split of embedding tables (torchrec ROW_WISE): leaves whose
    path matches ``pattern``, with >= 2 dims and a leading dim divisible by
    the axis size (and >= ``min_rows`` when given), get ``(axis, None,
    ...)``."""
    n = axis_size(mesh, axis)
    rx = re.compile(pattern)

    def rule(path: str, leaf):
        if getattr(leaf, "ndim", 0) < 2 or not rx.search(path):
            return None
        rows = leaf.shape[0]
        if rows % n or (min_rows is not None and rows < min_rows):
            return None
        return (axis, *([None] * (leaf.ndim - 1)))

    return rule


def min_size_partitioner_rule(mesh, min_shard_bytes: int = 256 * 1024,
                              axis: str = MODEL_AXIS) -> PlanRule:
    """TF ``MinSizePartitioner`` parity (the "PS" strategy): split any leaf
    whose per-shard size stays >= ``min_shard_bytes`` and whose leading dim
    divides."""
    n = axis_size(mesh, axis)

    def rule(path: str, leaf):
        if getattr(leaf, "ndim", 0) < 1 or n <= 1:
            return None
        if _nbytes(leaf) // n < min_shard_bytes or leaf.shape[0] % n:
            return None
        return (axis, *([None] * (leaf.ndim - 1)))

    return rule


def megatron_tp_rule(mesh, axis: str = MODEL_AXIS,
                     n_heads: int | None = None) -> PlanRule:
    """Megatron tensor parallelism of the transformer's dense layers, as
    placements of the flax-layout tree (``kernel [in, out]``):

    * column parallel (output features over ``axis``, biases along):
      ``fc1``, the vocab ``out_proj`` and the fused ``attn/qkv``, whose
      (head, qkv, dh) feature order makes the column split a head split;
    * row parallel (input features over ``axis``; the bias stays whole and
      is added once, after the sum): ``fc2`` and ``attn/out`` kernels.

    A leaf whose split dimension does not divide stays replicated.
    ``n_heads`` licenses the attention split: None leaves attention
    replicated (what ``attn = "flash"`` passes), and a head count the axis
    does not divide raises ``ValueError``."""
    col = re.compile(r"(fc1|out_proj|attn/qkv)/(kernel|bias)$")
    row = re.compile(r"(fc2|attn/out)/kernel$")
    attn_pat = re.compile(r"attn/(qkv|out)/")
    size = axis_size(mesh, axis)

    def rule(path: str, leaf):
        if not hasattr(leaf, "ndim"):
            return None
        if attn_pat.search(path):
            if n_heads is None:
                return None  # head alignment unproven: replicated
            if n_heads % size:
                raise ValueError(
                    f"tensor parallelism needs n_heads ({n_heads}) divisible "
                    f"by the {axis!r} mesh axis ({size}); pick a compatible "
                    "mesh or head count")
        if col.search(path):
            if leaf.ndim == 2 and leaf.shape[1] % size == 0:
                return (None, axis)
            if leaf.ndim == 1 and leaf.shape[0] % size == 0:
                return (axis,)
            return None
        if row.search(path) and leaf.ndim == 2 and leaf.shape[0] % size == 0:
            return (axis, None)
        return None

    return rule


def module_flax_paths(module) -> dict[str, tuple[str, bool]]:
    """``{torch parameter name: (flax path, transposed)}`` of a port
    module, the leaf named after the owning layer: ``nn.Linear.weight
    [out, in]`` is the flax ``kernel [in, out]`` (transposed),
    ``nn.LayerNorm.weight`` its ``scale``, ``nn.Embedding.weight`` its
    ``embedding``; biases and plain parameters (``pos_embed``) keep their
    names."""
    import torch

    leaves = ((torch.nn.Linear, "kernel"), (torch.nn.LayerNorm, "scale"),
              (torch.nn.Embedding, "embedding"))
    out = {}
    for name, _ in module.named_parameters():
        *path, leaf = name.split(".")
        owner = module.get_submodule(".".join(path)) if path else module
        if leaf == "weight":
            leaf = next((n for kind, n in leaves if isinstance(owner, kind)), leaf)
        out[name] = ("/".join([*path, leaf]), leaf == "kernel")
    return out


def module_plan(module, mesh, *rules: PlanRule) -> dict[str, tuple]:
    """:func:`make_sharding_plan` of a port module's parameters, in torch
    layout: ``{parameter name: placement}`` with a ``Linear`` weight's
    placement given for ``[out, in]``."""
    paths = module_flax_paths(module)
    params = dict(module.named_parameters())
    flax_view = {p: (params[n].detach().T if flip else params[n].detach())
                 for n, (p, flip) in paths.items()}
    plan = make_sharding_plan(flax_view, mesh, *rules)
    return {n: (tuple(reversed(plan[p])) if flip and plan[p] else plan[p])
            for n, (p, flip) in paths.items()}


def make_sharding_plan(tree: Mapping[str, Any], mesh, *rules: PlanRule
                       ) -> dict[str, tuple]:
    """``{path: placement}`` for a flat ``{path: leaf}`` tree: the first
    matching rule wins, replicated (``()``) by default."""
    plan = {}
    for path, leaf in tree.items():
        plan[path] = ()
        for rule in rules:
            spec = rule(path, leaf)
            if spec is not None:
                plan[path] = tuple(spec)
                break
    return plan


def _local_block(leaf, spec, mesh):
    """This rank's block of ``leaf`` under placement ``spec``."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n, k = axis_size(mesh, ax), axis_index(mesh, ax)
        size = leaf.shape[dim] // n
        index = [slice(None)] * leaf.ndim
        index[dim] = slice(k * size, (k + 1) * size)
        leaf = leaf[tuple(index)]
    return leaf


def shard_state(tree: Mapping[str, Any], mesh, *rules: PlanRule) -> dict[str, Any]:
    """This rank's block of every leaf under :func:`make_sharding_plan`:
    each split dimension sliced to the rank's index along its axis."""
    return {path: _local_block(tree[path], spec, mesh)
            for path, spec in make_sharding_plan(tree, mesh, *rules).items()}


def shard_module_(module, mesh, *rules: PlanRule) -> dict[str, tuple]:
    """Keep this rank's block of every parameter of ``module`` under
    :func:`module_plan` (each split parameter replaced by a fresh one of
    its block); returns the plan."""
    import torch

    plan = module_plan(module, mesh, *rules)
    for name, spec in plan.items():
        if not spec:
            continue
        *path, leaf = name.split(".")
        owner = module.get_submodule(".".join(path)) if path else module
        block = _local_block(getattr(owner, leaf).detach(), spec, mesh)
        setattr(owner, leaf, torch.nn.Parameter(block.clone()))
    return plan


def ps_shard_module_(module, mesh, *rules: PlanRule) -> dict[str, tuple]:
    """The PS partition of ``module`` (the reference shards the dense
    regime's state with ``min_size_partitioner_rule``): :func:`shard_module_`
    keeps this rank's block of every split parameter (an optimizer made
    after it holds block moments), and every forward of ``module`` reads
    each split parameter whole, all-gathered over the model axis by a
    forward pre-hook and put back after the forward.  The gather's backward
    is this rank's slice of the whole parameter's gradient: every model
    rank computes the same loss on the same rows, so the slice is the
    single-device gradient of the block (a sum over the axis would scale it
    by M).  Returns the plan."""
    from tdfo_tpu_torch.core.mesh import axis_group
    from tdfo_tpu_torch.parallel.collectives import SeqGather

    plan = shard_module_(module, mesh, *rules)
    split = []
    for name, spec in plan.items():
        if spec:
            *path, leaf = name.split(".")
            owner = module.get_submodule(".".join(path)) if path else module
            split.append((owner, leaf, spec.index(MODEL_AXIS)))
    if not split:
        return plan
    group = axis_group(mesh, MODEL_AXIS)
    blocks: list = []

    def gather(mod, args):
        for owner, leaf, dim in split:
            block = owner._parameters[leaf]
            blocks.append(block)
            # a plain tensor in the parameter's place, as torch.func's
            # functional_call puts one there, for this forward only
            owner._parameters[leaf] = SeqGather.apply(block, group, dim)

    def put_back(mod, args, out):
        for (owner, leaf, _), block in zip(split, blocks):
            owner._parameters[leaf] = block
        blocks.clear()

    module.register_forward_pre_hook(gather)
    module.register_forward_hook(put_back, always_call=True)
    return plan
