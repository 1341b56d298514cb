"""Process groups and the named device mesh — port of
``tdfo_tpu/core/mesh.py`` (``initialize_distributed``, ``_resolve_sizes``,
``make_mesh``).

One process per rank.  :func:`initialize_distributed` starts
``torch.distributed`` from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL for the card (each
rank on card ``LOCAL_RANK``), gloo for the CPU, each set explicitly.
:func:`make_mesh` lays the ranks out as a
``torch.distributed.device_mesh.DeviceMesh`` over the axes ``("data",
"model", "seq")``, data outermost as in the reference, with its size rules
(one ``-1`` wildcard; a product other than the world size is an error).
Rank ``r`` sits at ``(r // (model * seq), (r // seq) % model, r % seq)``:
a rank's model group is the ranks with its data and seq coordinates, its
data group the ranks with its model and seq coordinates, its seq group
the ranks with its data and model coordinates.  :func:`data_slice` and
:func:`seq_slice` are this rank's rows of a global batch and its chunk of
a sequence; :func:`plane_group` is the group of the ranks that share its
coordinates off some axes (the data x model plane of one seq index).

The reference's ``spoof_cpu_devices`` has no counterpart: CPU ranks are
gloo processes.  Two ranks can share one card only over gloo (NCCL refuses
two ranks on one device), by passing ``backend="gloo"`` with a CUDA
``device``.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from tdfo_tpu_torch.core.config import MeshSpec
from tdfo_tpu_torch.core.device import resolve_device

__all__ = ["AXES", "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "MeshSpec",
           "axis_group", "axis_index", "axis_size", "data_slice",
           "initialize_distributed", "make_mesh", "plane_group", "seq_slice"]

DATA_AXIS, MODEL_AXIS, SEQ_AXIS = "data", "model", "seq"
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)


def initialize_distributed(device="cuda", *, backend: str | None = None,
                           force: bool = False) -> bool:
    """Start the default process group from torchrun's environment
    variables; returns whether one is running.  A no-op at ``WORLD_SIZE``
    1 unless ``force`` (then a one-rank group, so the distributed code path
    runs on one process), and when a group is already up.  ``backend``:
    NCCL for a CUDA ``device`` and gloo for the CPU unless given."""
    if dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and not force:
        return False
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT", "29500")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world)
    return True


def _resolve_sizes(spec: MeshSpec, n_devices: int) -> tuple[int, ...]:
    sizes = list(spec.sizes())
    wildcard = [i for i, s in enumerate(sizes) if s == -1]
    if len(wildcard) > 1:
        raise ValueError("at most one mesh axis may be -1")
    fixed = math.prod(s for s in sizes if s != -1)
    if wildcard:
        if n_devices % fixed:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed mesh axes {sizes}"
            )
        sizes[wildcard[0]] = n_devices // fixed
    if math.prod(sizes) != n_devices:
        raise ValueError(f"mesh {sizes} != device count {n_devices}")
    return tuple(sizes)


def make_mesh(spec: MeshSpec | None = None, device="cuda"):
    """The ``DeviceMesh`` of the running process group, shaped by ``spec``
    (``core.config.MeshSpec``, the ``[mesh]`` table) over all its ranks;
    ``device``'s type is the mesh's device type."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a running process group: call "
            "initialize_distributed first (torchrun sets its environment)")
    sizes = _resolve_sizes(spec or MeshSpec(), dist.get_world_size())
    return init_device_mesh(resolve_device(device).type, sizes,
                            mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def data_slice(mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n`` split over the data
    axis (the whole batch without a mesh)."""
    k = axis_size(mesh, DATA_AXIS)
    if n % k:
        raise ValueError(f"global batch {n} does not split over data = {k}")
    i = axis_index(mesh, DATA_AXIS)
    return slice(i * (n // k), (i + 1) * (n // k))


def seq_slice(mesh, t: int) -> slice:
    """This rank's chunk of a sequence of ``t`` positions split over the
    seq axis (the whole sequence without a mesh)."""
    k = axis_size(mesh, SEQ_AXIS)
    if t % k:
        raise ValueError(f"sequence length {t} not divisible by seq axis {k}")
    i = axis_index(mesh, SEQ_AXIS)
    return slice(i * (t // k), (i + 1) * (t // k))


def plane_group(mesh, axes: tuple[str, ...]):
    """The process group of the ranks that share this rank's coordinates
    off ``axes`` (``("data", "model")``: the plane of its seq index), in
    row-major order over ``axes``.  Every rank makes every plane's group on
    the first call for a mesh (``new_group`` is collective); the mesh keeps
    them for later calls."""
    planes = mesh.__dict__.setdefault("_planes", {})
    axes = tuple(axes)
    if axes not in planes:
        ranks = mesh.mesh  # [data, model, seq] global ranks
        keep = [AXES.index(a) for a in axes]
        rest = [d for d in range(len(AXES)) if d not in keep]
        rows = ranks.permute(*rest, *keep).reshape(
            math.prod(ranks.shape[d] for d in rest), -1).tolist()
        mine = dist.get_rank()
        for row in rows:
            group = dist.new_group(row)
            if mine in row:
                planes[axes] = group
    return planes[axes]
