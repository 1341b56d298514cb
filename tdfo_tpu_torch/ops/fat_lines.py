"""Packed fat-line table layout — port of the layout helpers in
``tdfo_tpu/ops/pallas_kernels.py`` (``LineLayout`` .. ``fat_unpack``).

These are plain tensor code in both packages, not kernels.  A fused table
lives as ``[L, T, 128]`` lines; each vocab row owns a ``W``-lane slot
``[table (d) | optimizer state | zero pad]`` and ``R = T*128 / W`` rows
share a line.  The byte layout is kept exactly, so a fat array made by one
package compares directly (as an array) with the other's.  ``[L, T, 128]``
row-major is byte-identical to the ``[L*R, W]`` row view, so on the card
:func:`fat_view` is a free view.

The int8 byte-container lines of the reference are not ported yet
(``ROADMAP.md`` Queue A item 13): :func:`line_layout` refuses any storage
dtype but float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

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
    if _dtype_name(dtype) != "float32":
        raise NotImplementedError(
            f"fat-line storage dtype {_dtype_name(dtype)!r} is not ported yet "
            "(bf16 and int8 lines: ROADMAP.md Queue A item 13); float32 only")
    need = d + _STATE_LANES[kind](d)
    if need <= LANE:
        w = next(s for s in _SLOT_WIDTHS if s >= need)
        return LineLayout(d, kind, w, LANE // w, 1)
    tiles = -(-need // LANE)
    return LineLayout(d, kind, tiles * LANE, 1, tiles)


def fat_view(fat: torch.Tensor, layout: LineLayout) -> torch.Tensor:
    """[L, T, 128] lines -> [L*R, W] per-vocab-row view (no copy for a
    contiguous table; writes through it land in ``fat``)."""
    return fat.view(fat.shape[0] * layout.r, layout.w)


def fat_gather_rows(fat: torch.Tensor, ids: torch.Tensor,
                    layout: LineLayout) -> torch.Tensor:
    """Gather the table lanes of vocab rows ``ids`` (any shape; the output
    gains a trailing ``d`` axis).  Out-of-contract ids behave as in the
    reference, whose ``jnp.take`` of lines runs in jax's default
    ``mode="fill"``: negative ids read row 0, and an id whose line lies past
    the table reads a row of NaN.  Torch indexing would raise instead, so
    both rules are explicit."""
    ids = ids.to(torch.int64).clamp_min(0)
    line = ids // layout.r
    inside = line < fat.shape[0]
    idx = torch.where(inside, line, 0) * layout.r + ids % layout.r
    rows = fat_view(fat, layout)[idx, :layout.d]
    return torch.where(inside[..., None], rows, float("nan"))


def fat_pack(table: torch.Tensor, *state: torch.Tensor, kind: str = "adam",
             layout: LineLayout | None = None) -> torch.Tensor:
    """[V, d] table (+ per-kind optimizer state) -> [L, T, 128] fat lines.

    State arguments by kind: adam ``(mu[V,d], nu[V,d])``; adagrad
    ``(accum[V,d],)``; rowwise_adagrad ``(accum[V],)``; sgd none.  Missing
    state defaults to zeros (fresh init).  Padding rows/lanes are zero."""
    v, d = table.shape
    lay = layout or line_layout(d, kind)
    want = {"sgd": 0, "rowwise_adagrad": 1, "adagrad": 1, "adam": 2}[lay.kind]
    if state and len(state) != want:
        raise ValueError(f"{lay.kind} fat_pack takes {want} state arrays")
    dt, dev = torch.float32, table.device
    rows = torch.zeros((lay.padded_rows(v), lay.w), dtype=dt, device=dev)
    rows[:v, :d] = table
    if lay.kind == "rowwise_adagrad" and state:
        rows[:v, d] = state[0]
    elif lay.kind == "adagrad" and state:
        rows[:v, d:2 * d] = state[0]
    elif lay.kind == "adam" and state:
        rows[:v, d:2 * d] = state[0]
        rows[:v, 2 * d:3 * d] = state[1]
    return rows.view(-1, lay.tiles, LANE)


def fat_unpack(fat: torch.Tensor, layout: LineLayout,
               rows: int | None = None) -> tuple[torch.Tensor, ...]:
    """Inverse of :func:`fat_pack`: ``(table[V,d], *state)`` as views."""
    view = fat_view(fat, layout)
    if rows is not None:
        view = view[:rows]
    d = layout.d
    table = view[:, :d]
    if layout.kind == "sgd":
        return (table,)
    if layout.kind == "rowwise_adagrad":
        return table, view[:, d]
    if layout.kind == "adagrad":
        return table, view[:, d:2 * d]
    return table, view[:, d:2 * d], view[:, 2 * d:3 * d]
