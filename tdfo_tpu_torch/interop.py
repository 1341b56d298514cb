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
* :func:`tables_from_numpy` copies a table dict onto a device.  Fat tables
  already share the ``[L, T, 128]`` layout, so no reshaping happens.

The port's parity tolerance ladder is stated here once (:data:`TOL`), for
the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["TOL", "backbone_params_from_flax", "tables_from_numpy"]

# what is compared -> (rtol, atol); "exact" comparisons use equality
TOL = {
    "optimizer": (1e-6, 1e-7),     # optimizer elementwise math
    "logits": (1e-5, 1e-6),        # forward logits
    "trajectory": (1e-4, 1e-6),    # K-step trajectories
}


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
            out[f"{prefix}weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(v).T))
        elif k == "scale":
            out[f"{prefix}weight"] = torch.from_numpy(np.array(v))
        else:
            out[name] = torch.from_numpy(np.array(v))
    return out


def tables_from_numpy(tables: Mapping[str, np.ndarray], device="cpu") -> dict[str, torch.Tensor]:
    """Copy ``{array name: ndarray}`` (plain ``[V, d]`` or fat ``[L, T,
    128]``) into fresh tensors on ``device``."""
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in tables.items()}
