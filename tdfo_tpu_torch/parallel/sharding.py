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

``megatron_tp_rule`` (tensor parallelism) is ``ROADMAP.md`` Queue A item
12b and refuses.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping

from tdfo_tpu_torch.core.mesh import MODEL_AXIS, axis_index, axis_size

__all__ = ["PlanRule", "make_sharding_plan", "megatron_tp_rule",
           "min_size_partitioner_rule", "rowwise_embedding_rule", "shard_state"]

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


def megatron_tp_rule(mesh, axis: str = MODEL_AXIS, n_heads: int | None = None):
    """Tensor parallelism of the transformer's dense layers: not ported."""
    raise NotImplementedError(
        "megatron_tp_rule (tensor_parallel) is not ported to tdfo_tpu_torch "
        "yet (ROADMAP.md Queue A item 12b)")


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


def shard_state(tree: Mapping[str, Any], mesh, *rules: PlanRule) -> dict[str, Any]:
    """This rank's block of every leaf under :func:`make_sharding_plan`:
    each split dimension sliced to the rank's index along its axis."""
    out = {}
    for path, spec in make_sharding_plan(tree, mesh, *rules).items():
        leaf = tree[path]
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            n, k = axis_size(mesh, ax), axis_index(mesh, ax)
            size = leaf.shape[dim] // n
            index = [slice(None)] * leaf.ndim
            index[dim] = slice(k * size, (k + 1) * size)
            leaf = leaf[tuple(index)]
        out[path] = leaf
    return out
