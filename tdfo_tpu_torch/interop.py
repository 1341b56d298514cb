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
* :func:`dense_params_from_flax` maps a dense-regime model's flax tree
  (``init_twotower``'s or ``init_bert4rec``'s params) to the port's
  ``TwoTower`` or ``Bert4Rec`` state dict: each ``{name}/embedding [V, d]``
  becomes ``{name}.weight`` as it is, everything else goes through
  :func:`backbone_params_from_flax`.
* :func:`tables_from_numpy` copies a table dict onto a device.  Fat tables
  already share the ``[L, T, 128]`` layout, so no reshaping happens.
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

__all__ = ["TOL", "backbone_params_from_flax", "bf16_bits",
           "dense_params_from_flax", "tables_from_numpy", "to_torch"]

# what is compared -> (rtol, atol); "exact" comparisons use equality
TOL = {
    "optimizer": (1e-6, 1e-7),     # optimizer elementwise math
    "logits": (1e-5, 1e-6),        # forward logits
    "trajectory": (1e-4, 1e-6),    # K-step trajectories
}


def to_torch(a) -> torch.Tensor:
    """A fresh tensor holding ``a``'s values bit for bit (bf16: through the
    uint16 bit patterns, since numpy has no bfloat16 of its own)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.int16, copy=True)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


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


def tables_from_numpy(tables: Mapping[str, np.ndarray], device="cpu") -> dict[str, torch.Tensor]:
    """Copy ``{array name: ndarray}`` (plain ``[V, d]`` or fat ``[L, T,
    128]``, f32 or bf16) into fresh tensors on ``device``, bit for bit."""
    return {k: to_torch(v).to(device) for k, v in tables.items()}
