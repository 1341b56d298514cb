"""Narrow embedding storage: storage dtypes, stochastic rounding and int8
rowwise quantization — port of ``tdfo_tpu/ops/quant.py``.

Storage is narrow (``bfloat16``), compute stays f32: reads widen the small
gathered block after the row gather (never the table), writes requantize
here.  Stochastic rounding is the reference's bit trick: add uniform random
low-16 bits to the f32 bit pattern and truncate the mantissa.  It is
unbiased, and it is the identity on bf16-representable values (their low
16 bits are zero, so the add cannot carry), so untouched rows that ride
through a full-block requantize round-trip bit for bit.

Keys derive from ``(step, table_id)`` through ``fold_in`` chains of the
threefry port (``ops/threefry.py``), so the random bits, and hence every
stochastically rounded write, are bitwise those of the JAX package.  A key
is a host-side pair of ints; the bits are drawn on the tensor's device.

int8 storage is rowwise: a code ``q`` in ``[-128, 127]`` decodes as ``q *
scale + offset`` with one f32 ``(scale, offset)`` pair per row (the
``QSCALE_LAYOUT`` sidecar, ``[N, 2]``), fbgemm's rowwise-int8 TBE grid.
Every write recomputes the row's grid from its new values
(:func:`quantize_rows`), so int8 writes are row-sparse everywhere.  With a
key the codes round stochastically, ``floor(t + uniform)``, the uniform
drawn over the whole written block exactly as ``jax.random.uniform`` draws
it (``threefry.uniform``), so the same key and block shape give the JAX
package's codes bit for bit.  The fused byte-container lines carry the
sidecar and the f32 optimizer state as bytes (:func:`f32_to_bytes`,
:func:`bytes_to_f32`).  Every cast to int8 in this package lives in this
module.
"""

from __future__ import annotations

import zlib

import torch

from tdfo_tpu_torch.ops import threefry

__all__ = [
    "QSCALE_LAYOUT",
    "STORAGE_DTYPES",
    "bytes_to_f32",
    "component_key",
    "dequantize_rows",
    "f32_to_bytes",
    "quantize",
    "quantize_rows",
    "sr_key",
    "stochastic_round",
    "storage_dtype",
    "table_id",
]

# the storage dtypes the [embeddings] table_dtype knob accepts
STORAGE_DTYPES = ("float32", "bfloat16", "int8")

# the reference's layout stamp for the int8 per-row (scale, offset) sidecar
QSCALE_LAYOUT = "rowwise-f32-scale-offset-v1"

# f32(1 / 255): XLA rewrites the reference's divide by the constant 255 as
# this multiply, so the port computes the grid the same way
_INV_255 = float(torch.tensor(1.0 / 255.0, dtype=torch.float32))

# arbitrary fixed base; all variation comes from the (step, table) folds
_SR_BASE = 0x5EED

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}


def storage_dtype(name) -> torch.dtype:
    """A storage dtype name (``"float32"`` / ``"bfloat16"`` / ``"int8"``)
    or torch dtype -> the torch dtype."""
    if isinstance(name, torch.dtype):
        name = str(name).removeprefix("torch.")
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unknown storage dtype {name!r}; one of "
                         f"{STORAGE_DTYPES}")
    return _TORCH_DTYPES[name]


def table_id(name: str) -> int:
    """Stable 31-bit id of a table/array name for key folding."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def sr_key(step: int, name: str) -> threefry.Key:
    """Counter-derived threefry key for stochastic rounding at ``step`` on
    array ``name``: a pure function of (step, table_id), bitwise the JAX
    package's ``sr_key``."""
    k = threefry.PRNGKey(_SR_BASE)
    k = threefry.fold_in(k, int(step))
    return threefry.fold_in(k, table_id(name))


def component_key(key: threefry.Key | None, index: int) -> threefry.Key | None:
    """Distinct subkey per written component (0 = table, 1 = mu/accum,
    2 = nu).  None passes through (f32 path)."""
    return None if key is None else threefry.fold_in(key, index)


def stochastic_round(x: torch.Tensor, dtype, key: threefry.Key) -> torch.Tensor:
    """f32 -> ``dtype`` (bf16) with unbiased stochastic rounding: the random
    low-16 bits of element ``n`` (row major) are those ``jax.random.bits``
    draws for it under ``key``."""
    x = x.to(torch.float32).contiguous()
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rand = threefry.bits(key, x.shape, x.device) & 0xFFFF
    out = (u + rand) & 0xFFFF0000
    out = torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)
    return out.view(torch.float32).to(dtype)


def quantize(x: torch.Tensor, dtype, key: threefry.Key | None = None) -> torch.Tensor:
    """Cast ``x`` to the storage ``dtype``: stochastic rounding when
    narrowing with a key, round-to-nearest without one, and a plain cast to
    f32 (the default path stays what unquantized storage computes).  int8
    needs its per-row sidecar, so it goes through :func:`quantize_rows`."""
    dtype = storage_dtype(dtype)
    if dtype == torch.int8:
        raise ValueError(
            "int8 storage carries a per-row (scale, offset) sidecar — use "
            "quantize_rows/dequantize_rows, not the scalar quantize path"
        )
    if dtype == torch.float32 or key is None:
        return x.to(dtype)
    return stochastic_round(x, dtype, key)


def quantize_rows(x: torch.Tensor, key: threefry.Key | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 rows ``[N, D]`` -> (int8 codes ``[N, D]``, f32 ``[N, 2]`` (scale,
    offset) sidecar).  ``scale = (max - min) / 255`` (1 for a constant
    row, whose codes are then 0 and whose offset carries the value),
    ``offset = min + 128 scale``; codes are ``(x - offset) / scale`` rounded
    to nearest (ties to even) without a key, ``floor(t + uniform)`` with
    one, clipped to ``[-128, 127]``."""
    x = x.to(torch.float32)
    rmin = torch.amin(x, dim=-1, keepdim=True)
    rmax = torch.amax(x, dim=-1, keepdim=True)
    scale = (rmax - rmin) * _INV_255
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    offset = rmin + 128.0 * scale
    t = (x - offset) / scale
    if key is None:
        q = torch.round(t)
    else:
        q = torch.floor(t + threefry.uniform(key, x.shape, device=x.device))
    data = torch.clamp(q, -128.0, 127.0).to(torch.int8)
    return data, torch.cat([scale, offset], dim=-1)


def f32_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """f32 ``[..., K]`` -> int8 ``[..., 4*K]`` byte view (the bits as they
    are, little-endian, as ``jax.lax.bitcast_convert_type`` lays them)."""
    x = x.to(torch.float32).contiguous()
    return x.view(torch.int8).reshape(*x.shape[:-1], x.shape[-1] * 4)


def bytes_to_f32(b: torch.Tensor) -> torch.Tensor:
    """int8 ``[..., 4*K]`` byte view -> f32 ``[..., K]`` (inverse of
    :func:`f32_to_bytes`, bits untouched)."""
    if b.shape[-1] % 4:
        raise ValueError(f"byte lane count {b.shape[-1]} is not a multiple of 4")
    return b.contiguous().view(torch.float32)


def dequantize_rows(data, qscale):
    """int8 codes ``[..., D]`` + f32 ``[..., 2]`` sidecar -> f32 rows, for
    tensors and for numpy arrays (the host-side table views).  The decode
    ``q * scale + offset`` rounds once, as the fused multiply-add XLA
    compiles the reference's into: the product of an int8 code and an f32
    scale is exact in f64, so the sum is formed in f64 and rounded to f32."""
    if isinstance(data, torch.Tensor) or isinstance(qscale, torch.Tensor):
        qs = qscale.to(torch.float64)
        return (data.to(torch.float64) * qs[..., 0:1]
                + qs[..., 1:2]).to(torch.float32)
    import numpy as np

    qs = np.asarray(qscale, np.float64)
    return (np.asarray(data, np.float64) * qs[..., 0:1]
            + qs[..., 1:2]).astype(np.float32)
