"""Carry weights and state between the JAX package and the port, as numpy.

Both sides meet in numpy arrays, so this module imports neither jax nor the
JAX package:

* :func:`backbone_params_from_flax` maps a flax param tree (nested dicts of
  numpy arrays, as ``jax.tree.map(np.asarray, params)`` gives) to a torch
  ``state_dict``: each ``Dense.kernel [in, out]`` becomes
  ``Linear.weight [out, in]``, each ``LayerNorm.scale`` becomes
  ``LayerNorm.weight``; biases and plain parameters (``pos_embed``) carry
  over.  Module names are kept, so a TwoTower, ``DLRMBackbone`` or
  ``Bert4RecBackbone`` tree loads with ``load_state_dict(strict=True)``; the fused ``qkv`` kernel
  keeps its (head, qkv, dh) column order, which the port's attention reads
  the same way.
* :func:`tp_backbone_params_from_flax` is the same for one rank of a
  Megatron tensor-parallel backbone: the flax tree's leaves are first cut
  to this rank's blocks by the plan of
  ``parallel.sharding.megatron_tp_rule`` (the reference's plan for the
  same tree), so the result loads into a backbone after its
  ``shard_tensor_parallel_``.
* :func:`dense_params_from_flax` maps a dense-regime model's flax tree
  (``init_twotower``'s or ``init_bert4rec``'s params) to the port's
  ``TwoTower`` or ``Bert4Rec`` state dict: each ``{name}/embedding [V, d]``
  becomes ``{name}.weight`` as it is, everything else goes through
  :func:`backbone_params_from_flax`.
* :func:`flax_params_from_module` is the way back: a port module's
  parameters as the reference's flax tree of numpy arrays (``Linear``
  weights transposed to ``kernel [in, out]``, ``LayerNorm`` weights named
  ``scale``, ``Embedding`` weights named ``embedding``).  Serving bundles
  store dense parameters in that form, so a bundle written by either
  package loads in the other (``serve/export.py``).
* :func:`tables_from_numpy` copies a table dict onto a device.  Fat tables
  already share the ``[L, T, 128]`` layout (int8 byte lines included), so
  no reshaping happens; int8 codes, their ``__qscale__/`` sidecars and hot
  heads carry over as they are.  :func:`tree_from_numpy` does the same for
  any tree of arrays: optimizer slots, and update caches (dicts), whose
  keys are the reference's.
* :func:`shard_from_numpy` carries global arrays to a rank under a mesh:
  the JAX package's tables and slots (padded as its sharded ``init`` pads
  them, or in the single-device layout) become this rank's shards of the
  port's collection; :func:`gather_to_numpy` gathers the port's shards back
  into global numpy arrays (in the single-device layout) for comparisons.
* :func:`to_torch` carries one array over bit for bit, bf16 included: an
  ``ml_dtypes`` bfloat16 array (what ``np.asarray`` of a JAX bf16 array
  gives) is viewed as uint16 and then as ``torch.bfloat16``.
  :func:`bf16_bits` is the way back for comparisons: the uint16 bit
  patterns of a bf16 tensor or array.

The port's parity tolerance ladder is stated here once (:data:`TOL`), for
the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["TOL", "backbone_params_from_flax", "bf16_bits", "tp_backbone_params_from_flax",
           "dense_params_from_flax", "flax_params_from_module",
           "gather_to_numpy", "shard_from_numpy", "tables_from_numpy",
           "to_numpy", "to_torch", "tree_from_numpy"]

# what is compared -> (rtol, atol); "exact" comparisons use equality
TOL = {
    "optimizer": (1e-6, 1e-7),     # optimizer elementwise math
    "logits": (1e-5, 1e-6),        # forward logits
    "trajectory": (1e-4, 1e-6),    # K-step trajectories
}


def to_torch(a) -> torch.Tensor:
    """A fresh CPU tensor holding ``a``'s values bit for bit (a tensor is
    copied; a bf16 array goes through its uint16 bit patterns, since numpy
    has no bfloat16 of its own)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().clone()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.int16, copy=True)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``'s values; bf16 (which numpy lacks) comes back
    as f32, exactly."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def bf16_bits(x) -> np.ndarray:
    """The uint16 bit patterns of a bf16 tensor (any device) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint16)


def backbone_params_from_flax(tree: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """Flatten a flax param tree into a torch ``state_dict``
    (``user_tower/fc1/kernel`` -> ``user_tower.fc1.weight``, transposed;
    ``block_0/ln_ff/scale`` -> ``block_0.ln_ff.weight``)."""
    out: dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(backbone_params_from_flax(v, prefix=name + "."))
        elif k == "kernel":
            out[f"{prefix}weight"] = to_torch(np.ascontiguousarray(np.asarray(v).T))
        elif k == "scale":
            out[f"{prefix}weight"] = to_torch(v)
        else:
            out[name] = to_torch(v)
    return out


def _flat(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def tp_backbone_params_from_flax(tree: Mapping, mesh,
                                 n_heads: int | None) -> dict[str, torch.Tensor]:
    """This rank's tensor-parallel shards of a flax backbone tree, as a
    torch ``state_dict`` (the split dims of ``megatron_tp_rule(mesh,
    n_heads=n_heads)``'s plan sliced to the rank's model index)."""
    from tdfo_tpu_torch.parallel.sharding import megatron_tp_rule, shard_state

    local = shard_state(_flat(tree), mesh, megatron_tp_rule(mesh, n_heads=n_heads))
    nested: dict = {}
    for path, v in local.items():
        *keys, leaf = path.split("/")
        node = nested
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(v)
    return backbone_params_from_flax(nested)


def dense_params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """A dense-regime model's flax params -> the port model's ``state_dict``
    (loads with ``strict=True``)."""
    out: dict[str, torch.Tensor] = {}
    rest = {}
    for k, v in tree.items():
        if isinstance(v, Mapping) and set(v) == {"embedding"}:
            out[f"{k}.weight"] = to_torch(v["embedding"])
        else:
            rest[k] = v
    out.update(backbone_params_from_flax(rest))
    return out


def flax_params_from_module(module: torch.nn.Module, params=None) -> dict:
    """A port module's parameters as the reference's flax param tree (nested
    dicts of numpy arrays): the inverse of :func:`dense_params_from_flax`
    and :func:`backbone_params_from_flax`, with the leaves named by
    ``parallel.sharding.module_flax_paths`` (``Linear`` weights transposed
    to ``kernel [in, out]``, ``LayerNorm`` weights named ``scale``,
    ``Embedding`` weights named ``embedding``).  ``params``: the values by
    parameter name in the module's place (a sharded module's parameters
    gathered whole)."""
    from tdfo_tpu_torch.parallel.sharding import module_flax_paths

    params = dict(params if params is not None else module.named_parameters())
    tree: dict = {}
    for name, (path, flip) in module_flax_paths(module).items():
        *keys, leaf = path.split("/")
        v = to_numpy(params[name])
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(v.T) if flip else v
    return tree


def tables_from_numpy(tables: Mapping[str, np.ndarray], device="cpu") -> dict[str, torch.Tensor]:
    """Copy ``{array name: ndarray}`` (plain ``[V, d]`` or fat ``[L, T,
    128]``, f32 or bf16) into fresh tensors on ``device``, bit for bit."""
    return {k: to_torch(v).to(device) for k, v in tables.items()}


def tree_from_numpy(tree, device="cpu"):
    """A tree of arrays (dicts, tuples, lists) -> the same tree of fresh
    tensors on ``device``, bit for bit (slots, update caches)."""
    if isinstance(tree, Mapping):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, device) for v in tree)
    return to_torch(tree).to(device)


def shard_from_numpy(coll, tables: Mapping[str, np.ndarray], slots=None,
                     device="cpu"):
    """``(tables, slots)``: this rank's shards of global table and slot
    arrays under ``coll``'s mesh (whole arrays without one), bit for bit.
    Rows past the port's global padding must be absent; rows short of it
    are zero-padded."""
    t = tables_from_numpy(tables, device)
    s = tree_from_numpy(slots or {}, device)
    return coll.local_arrays(t, s)


def gather_to_numpy(coll, tables, slots=None):
    """``(tables, slots)`` as global numpy arrays in the single-device
    layout, gathered over ``coll``'s model axis (every rank calls this)."""
    gt, gs = coll.global_arrays(tables, slots or {})
    return ({k: to_numpy(v) for k, v in gt.items()},
            {k: ({c: to_numpy(x) for c, x in v.items()} if isinstance(v, dict)
                 else type(v)(to_numpy(x) for x in v)) for k, v in gs.items()})
