"""Packed fat-line table layout — port of the layout helpers in
``tdfo_tpu/ops/pallas_kernels.py`` (``LineLayout`` .. ``fat_unpack``).

These are plain tensor code in both packages, not kernels.  A fused table
lives as ``[L, T, 128]`` lines; each vocab row owns a ``W``-lane slot
``[table (d) | optimizer state | zero pad]`` and ``R = T*128 / W`` rows
share a line.  The byte layout is kept exactly, so a fat array made by one
package compares directly (as an array) with the other's.  ``[L, T, 128]``
row-major is byte-identical to the ``[L*R, W]`` row view, so on the card
:func:`fat_view` is a free view.

bf16 lines have the f32 geometry (the reference's ``line_layout`` reads
the dtype only for int8): table and optimizer state share the line's
storage dtype, every lane is bf16, and gathers widen to f32 after the
gather.

int8 lines are byte containers: each row's slot holds ``[d code bytes |
8 bytes of the f32 (scale, offset) pair | 4 bytes per f32 state lane |
zero pad]``, so only the table lanes are quantized and the optimizer state
rides as exact f32 bit patterns.  ``rowwise_adagrad`` refuses int8 lines,
as in the reference.  int8 lines are updated row by row
(``ops/sparse.py::_fat_apply_rows_int8``), never by the fat-line kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tdfo_tpu_torch.ops.quant import (
    bytes_to_f32,
    dequantize_rows,
    f32_to_bytes,
    quantize_rows,
)

__all__ = [
    "LineLayout",
    "line_layout",
    "fat_view",
    "fat_gather_rows",
    "fat_pack",
    "fat_unpack",
]

LANE = 128  # lanes per tile: the shared [L, T, 128] layout
_SLOT_WIDTHS = (8, 16, 32, 64, 128)

# optimizer-state lanes per vocab row, after the d table lanes
_STATE_LANES = {
    "sgd": lambda d: 0,
    "rowwise_adagrad": lambda d: 1,   # ONE f32 accumulator cell per row
    "adagrad": lambda d: d,           # per-element squared-grad accumulator
    "adam": lambda d: 2 * d,          # mu | nu moments
}


@dataclass(frozen=True)
class LineLayout:
    """Static description of a packed fat-line table for (d, kind)."""

    d: int
    kind: str
    w: int      # lanes per vocab row (slot width): [table(d) | state | pad]
    r: int      # vocab rows per line (r * w == tiles * 128)
    tiles: int  # trailing [tiles, 128] shape per line
    dtype: str = "float32"

    @property
    def state_lanes(self) -> int:
        return _STATE_LANES[self.kind](self.d)

    @property
    def need(self) -> int:
        if self.dtype == "int8":
            # codes + bitcast f32 (scale, offset) + bitcast f32 state
            return self.d + 8 + 4 * self.state_lanes
        return self.d + self.state_lanes

    def n_lines(self, rows: int) -> int:
        return -(-rows // self.r)

    def padded_rows(self, rows: int) -> int:
        return self.n_lines(rows) * self.r


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def line_layout(d: int, kind: str, dtype="float32") -> LineLayout:
    if kind not in _STATE_LANES:
        raise ValueError(f"unknown fused optimizer kind: {kind!r}")
    name = _dtype_name(dtype)
    if name == "int8":
        if kind == "rowwise_adagrad":
            raise ValueError(
                "fused int8 storage does not support rowwise_adagrad: the "
                "f32 per-row accumulator contract cannot ride a quantized "
                "line (use optimizer = adagrad/adam/sgd, or fused = false)")
        need = d + 8 + 4 * _STATE_LANES[kind](d)
        if need <= LANE:
            w = next(s for s in _SLOT_WIDTHS if s >= need)
            return LineLayout(d, kind, w, LANE // w, 1, "int8")
        tiles = -(-need // LANE)
        return LineLayout(d, kind, tiles * LANE, 1, tiles, "int8")
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"fat-line storage dtype must be float32, "
                         f"bfloat16 or int8, got {name!r}")
    need = d + _STATE_LANES[kind](d)
    if need <= LANE:
        w = next(s for s in _SLOT_WIDTHS if s >= need)
        return LineLayout(d, kind, w, LANE // w, 1, name)
    tiles = -(-need // LANE)
    return LineLayout(d, kind, tiles * LANE, 1, tiles, name)


def fat_view(fat: torch.Tensor, layout: LineLayout) -> torch.Tensor:
    """[L, T, 128] lines -> [L*R, W] per-vocab-row view (no copy for a
    contiguous table; writes through it land in ``fat``)."""
    return fat.view(fat.shape[0] * layout.r, layout.w)


def fat_gather_rows(fat: torch.Tensor, ids: torch.Tensor,
                    layout: LineLayout) -> torch.Tensor:
    """Gather the table lanes of vocab rows ``ids`` (any shape; the output
    gains a trailing ``d`` axis), widened to f32 after the gather.
    Out-of-contract ids behave as in the reference, whose ``jnp.take`` of
    lines runs in jax's default ``mode="fill"``: negative ids read row 0,
    and an id whose line lies past the table reads a row of NaN.  Torch
    indexing would raise instead, so both rules are explicit."""
    ids = ids.to(torch.int64).clamp_min(0)
    line = ids // layout.r
    inside = line < fat.shape[0]
    idx = torch.where(inside, line, 0) * layout.r + ids % layout.r
    if layout.dtype == "int8":
        # codes and the adjacent sidecar bytes, decoded on the small
        # gathered block; a line past the table fills with the int8 fill
        # value (-128), as jnp.take does
        span = fat_view(fat, layout)[idx, :layout.d + 8]
        span = torch.where(inside[..., None], span, -128)
        return dequantize_rows(span[..., :layout.d],
                               bytes_to_f32(span[..., layout.d:]))
    rows = fat_view(fat, layout)[idx, :layout.d].to(torch.float32)
    return torch.where(inside[..., None], rows, float("nan"))


def fat_pack(table: torch.Tensor, *state: torch.Tensor, kind: str = "adam",
             layout: LineLayout | None = None, dtype=None,
             qscale: torch.Tensor | None = None) -> torch.Tensor:
    """[V, d] table (+ per-kind optimizer state) -> [L, T, 128] fat lines.

    State arguments by kind: adam ``(mu[V,d], nu[V,d])``; adagrad
    ``(accum[V,d],)``; rowwise_adagrad ``(accum[V],)``; sgd none.  Missing
    state defaults to zeros (fresh init).  Padding rows/lanes are zero.
    ``dtype`` is the lines' storage dtype (default the layout's, else the
    table's): the line is assembled in f32 and rounded to nearest once, as
    the reference's per-component ``astype``.

    int8 lines are byte containers: an f32 ``table`` is quantized here
    (round to nearest, the plain int8 init's grid); an int8 ``table`` of
    codes needs its ``qscale`` f32 ``[V, 2]`` sidecar.  State rides as f32
    bytes."""
    v, d = table.shape
    if dtype is None:
        dtype = layout.dtype if layout is not None else table.dtype
    lay = layout or line_layout(d, kind, dtype)
    want = {"sgd": 0, "rowwise_adagrad": 1, "adagrad": 1, "adam": 2}[lay.kind]
    if state and len(state) != want:
        raise ValueError(f"{lay.kind} fat_pack takes {want} state arrays")
    dev = table.device
    if lay.dtype == "int8":
        if table.dtype == torch.int8:
            if qscale is None:
                raise ValueError(
                    "fat_pack of int8 codes needs the f32 (scale, offset) "
                    "qscale sidecar")
            codes, qs = table, qscale.to(torch.float32)
        else:
            codes, qs = quantize_rows(table)
        rows = torch.zeros((lay.padded_rows(v), lay.w), dtype=torch.int8,
                           device=dev)
        rows[:v, :d] = codes
        rows[:v, d:d + 8] = f32_to_bytes(qs)
        for i, st in enumerate(state):
            rows[:v, d + 8 + 4 * d * i:d + 8 + 4 * d * (i + 1)] = f32_to_bytes(st)
        return rows.view(-1, lay.tiles, LANE)
    dt = torch.float32
    rows = torch.zeros((lay.padded_rows(v), lay.w), dtype=dt, device=dev)
    rows[:v, :d] = table
    if lay.kind == "rowwise_adagrad" and state:
        rows[:v, d] = state[0]
    elif lay.kind == "adagrad" and state:
        rows[:v, d:2 * d] = state[0]
    elif lay.kind == "adam" and state:
        rows[:v, d:2 * d] = state[0]
        rows[:v, 2 * d:3 * d] = state[1]
    rows = rows.to(getattr(torch, lay.dtype))
    return rows.view(-1, lay.tiles, LANE)


def fat_unpack(fat: torch.Tensor, layout: LineLayout,
               rows: int | None = None) -> tuple[torch.Tensor, ...]:
    """Inverse of :func:`fat_pack`: ``(table[V,d], *state)`` as views, at
    the lines' storage dtype.  int8 lines return ``(codes[V,d] int8,
    qscale[V,2] f32, *state f32)`` (copies: the byte lanes are decoded)."""
    view = fat_view(fat, layout)
    if rows is not None:
        view = view[:rows]
    d = layout.d
    table = view[:, :d]
    if layout.dtype == "int8":
        n = {"sgd": 0, "adagrad": 1, "adam": 2}[layout.kind]
        return (table, bytes_to_f32(view[:, d:d + 8]),
                *(bytes_to_f32(view[:, d + 8 + 4 * d * i:d + 8 + 4 * d * (i + 1)])
                  for i in range(n)))
    if layout.kind == "sgd":
        return (table,)
    if layout.kind == "rowwise_adagrad":
        return table, view[:, d]
    if layout.kind == "adagrad":
        return table, view[:, d:2 * d]
    return table, view[:, d:2 * d], view[:, 2 * d:3 * d]
