"""The collectives of the sharded embedding programs, each a
``torch.autograd.Function`` where a gradient flows through it.

The reference writes these programs inside ``shard_map`` with ``psum``,
``all_gather`` and ``all_to_all`` (``tdfo_tpu/parallel/embedding.py:1579-1706``)
and lets JAX transpose them.  Here each is a ``torch.distributed`` call on
a process group, and its backward is written out:

* :class:`AllReduceSum` (the psum lookup's assembly): forward sums over the
  group; backward passes the gradient through unchanged, because the
  downstream work is replicated over the group, so every rank already holds
  the whole gradient of the assembled vectors.  A psum lookup's gradient
  therefore reaches each owned row exactly once (the reference pins the
  same: ``tests/test_embedding_collection.py:92-101``).
* :class:`AllToAll` (the alltoall lookup's return trip): forward sends
  block ``j`` to rank ``j``; backward sends the gradient blocks back the
  same way (an equal-split all-to-all is its own transpose).
* :class:`Ppermute` (the ring's rotation, the reference's
  ``jax.lax.ppermute`` with ``perm = [(i, (i + 1) % P)]``): forward sends
  to group rank ``(i + 1) % P`` and receives from ``(i - 1) % P``;
  backward rotates the gradient the other way.
* :class:`SeqScatter` (a tensor replicated over the seq axis becomes this
  rank's chunk along a dimension): backward all-gathers the chunks'
  gradients, because the work upstream is replicated over the group and
  needs the whole gradient on every rank.  :class:`SeqGather` is its
  mirror: forward concatenates the ranks' chunks, backward keeps this
  rank's block of the gradient (the ring's output, and along the last
  dimension the column lookup's blocks).
* Megatron's two operators over the model axis: :class:`CopyToModel`
  (identity forward, sum of the gradients backward: the input of a
  column-parallel layer) and :class:`AllReduceSum`, which is
  reduce-from-model (sum forward, identity backward: the output of a
  row-parallel layer).

:func:`all_to_all` is ``all_to_all_single`` with equal splits, for int32 /
int64 ids and f32, bf16 and int8 payloads alike; with ``async_op`` it
returns the work handle beside the output (the pipelined step waits on it
before it reads the output).  A backend that refuses a dtype on a device
raises a ``RuntimeError`` naming the backend, the dtype and the device:
nothing is cast to a dtype the backend takes.

:func:`ring_shift` is the rotation itself.  Its form follows the
backend, by name: NCCL takes the pair of point-to-point calls
(``batch_isend_irecv``); gloo, which the card runs when two ranks share
one device, takes an ``all_to_all_single`` whose splits send the whole
tensor to one neighbour (gloo moves CUDA all-to-alls, as the sharded
lookups already rely on).  Bool tensors travel as their bytes.

The plain helpers (:func:`all_gather_cat`, :func:`all_reduce_`,
:func:`all_to_all`, :func:`gather_to_host`) serve the update, the metrics
and the checkpoints, where nothing is differentiated.  Every call moves
the tensors as they are (a CUDA tensor stays on its card; only
:func:`gather_to_host`'s result lands on the host, where a checkpoint is
written from): a backend that refuses a collective on that device raises,
and nothing copies to the host to get round it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["AllReduceSum", "AllToAll", "CopyToModel",
           "Ppermute", "SeqGather", "SeqScatter", "all_gather_cat",
           "all_reduce_", "all_reduce_tensors", "all_to_all", "gather_to_host",
           "ring_shift"]


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group``; returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_tensors(tensors, group) -> list[torch.Tensor]:
    """Sums of ``tensors`` over ``group``: one collective per dtype (the
    tensors flattened into one buffer)."""
    tensors = list(tensors)
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = all_reduce_(torch.cat([tensors[i].reshape(-1) for i in idx]), group)
        for i, part in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors (equal shapes), concatenated along ``dim`` in
    group-rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_to_host(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor | None:
    """The group's tensors (equal shapes) concatenated along ``dim`` in
    group-rank order, on the host of group rank 0; the other ranks get
    None.  One rank's tensor at a time (a broadcast each, which both NCCL
    and gloo take on the card), so no rank holds more than one extra
    tensor of ``x``'s size on its device."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return x.cpu()
    parts = []
    for k in range(n):
        buf = x.contiguous() if k == me else torch.empty_like(x)
        dist.broadcast(buf, src=dist.get_global_rank(group, k), group=group)
        if me == 0:
            parts.append(buf.cpu())
    return torch.cat(parts, dim=dim) if me == 0 else None


def all_to_all(x: torch.Tensor, group, *, async_op: bool = False):
    """``x [n * k, ...]``: block ``j`` (rows ``j*k .. (j+1)*k``) goes to
    group rank ``j``; returns the blocks received, in rank order, or with
    ``async_op`` ``(received, work)``: the output is defined only once
    ``work.wait()`` has returned, and ``x`` and the output must live until
    then."""
    out = torch.empty_like(x)
    try:
        work = dist.all_to_all_single(out, x.contiguous(), group=group,
                                      async_op=async_op)
    except RuntimeError as e:
        raise RuntimeError(
            f"backend {dist.get_backend(group)!r} refuses all_to_all_single "
            f"of {x.dtype} on {x.device.type}: {e}") from e
    return (out, work) if async_op else out


def ring_shift(x: torch.Tensor, group, *, reverse: bool = False) -> torch.Tensor:
    """``x`` to group rank ``(i + 1) % P``; returns the tensor of rank
    ``(i - 1) % P`` (``reverse``: the other way round).  The identity on a
    group of one."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    me = dist.get_rank(group)
    step = -1 if reverse else 1
    dst, src = (me + step) % n, (me - step) % n
    x = x.contiguous()
    out = torch.empty_like(x)
    send, recv = ((x.view(torch.uint8), out.view(torch.uint8))
                  if x.dtype == torch.bool else (x, out))
    if dist.get_backend(group) == "nccl":
        ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst), group),
               dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src), group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    else:
        k = send.numel()
        dist.all_to_all_single(recv.view(-1), send.view(-1),
                               [k if j == src else 0 for j in range(n)],
                               [k if j == dst else 0 for j in range(n)],
                               group=group)
    return out


def _chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, k = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of size {size} does not split "
                         f"over {n} ranks")
    return x.narrow(dim, k * (size // n), size // n).contiguous()


class Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_shift(x, group)

    @staticmethod
    def backward(ctx, grad):
        return ring_shift(grad, ctx.group, reverse=True), None


class SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad, ctx.group, dim=ctx.dim), None, None


class SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return _chunk(grad, ctx.group, ctx.dim), None, None


class CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(grad, ctx.group), None
