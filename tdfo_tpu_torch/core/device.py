"""Device policy of the port's entry points.

Entry points (``launch.py --device``, ``Trainer(cfg, device=...)``,
``ShardedEmbeddingCollection.init(..., device=...)``) run on the card unless
the caller asks for the CPU: the default is ``"cuda"``, and asking for CUDA
where there is none raises instead of quietly training on the CPU.  Library
functions below them run wherever their tensors live.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is false; pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev
