"""The routed fat-line path of the PyTorch port (the dedup lookup's update)
against ``tdfo_tpu/ops/sparse.py``: ``dedupe_rows_and_lines`` exactly,
``fat_apply_routed`` / ``fat_apply_unique`` within ``TOL["optimizer"]``
(rtol 1e-6 / atol 1e-7, elementwise optimizer math), the routed update
bitwise equal to the port's own ``fat_update`` on the CPU, and the routed
plain version leaving every untouched slot and sentinel row bitwise
unchanged.  The JAX side runs ``fat_apply_routed(..., interpret=False)``,
its XLA formulation, which the JAX package's own tests hold equal to the
Pallas kernel."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdfo_tpu.ops import sparse as jsp
from tdfo_tpu.ops.pallas_kernels import fat_pack as j_fat_pack
from tdfo_tpu_torch.interop import TOL
from tdfo_tpu_torch.ops import sparse as tsp
from tdfo_tpu_torch.ops.fat_lines import fat_view, line_layout
from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as tkr
from tdfo_tpu_torch.parallel.embedding import take_fill

RTOL, ATOL = TOL["optimizer"]
OOB = 2**31 - 1
LR, WD = 1e-2, 1e-3


def _ids(rng, v, b):
    """Ids with duplicates and negatives (-1 and -3)."""
    ids = rng.integers(0, v, b).astype(np.int32)
    ids[1:b - 1:7] = ids[2::7][: len(ids[1:b - 1:7])]
    ids[::11] = -1
    ids[5::23] = -3
    return ids


@pytest.mark.parametrize("r,v,b,cap_r,cap_l", [
    (4, 500, 300, 300, 300),   # R = 4, ample capacities
    (4, 40, 300, 48, 16),      # capacity below B (vocab-bounded)
    (8, 200, 150, 150, 8),     # lines past capacity drop
    (1, 90, 120, 120, 120),    # one row per line
    (2, 60, 100, 40, 24),      # rows past capacity drop too
])
def test_dedupe_rows_and_lines_exact(r, v, b, cap_r, cap_l):
    ids = _ids(np.random.default_rng(r * 1000 + v), v, b)
    kw = dict(capacity_rows=cap_r, capacity_lines=cap_l, rows_per_line=r)
    want = jax.jit(functools.partial(jsp.dedupe_rows_and_lines, **kw))(
        jnp.asarray(ids))
    got = tsp.dedupe_rows_and_lines(torch.from_numpy(ids), **kw)
    for name, g, w in zip(("seg_row", "ulines", "row_lidx", "row_slot"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert [t.dtype for t in got[1:]] == [torch.int32] * 3
    # the sentinel row: a real line slot holding the sentinel line, slot 0
    neg = got[0][torch.from_numpy(ids) < 0].unique()
    assert neg.numel() == 1
    if int(neg) < cap_r and int(got[2][neg]) < cap_l:
        assert int(got[1][got[2][neg]]) == OOB and int(got[3][neg]) == 0


def _routed_operands(rng, kind, d, v=400, b=300):
    """A JAX-packed fat table with random state, and a step's ids and
    grads (grads zero at negative ids, as the step's are)."""
    table = rng.standard_normal((v, d)).astype(np.float32)
    state = {"sgd": (), "rowwise_adagrad": (rng.random(v),),
             "adagrad": (rng.random((v, d)),),
             "adam": (rng.standard_normal((v, d)) * 0.1, rng.random((v, d)))}[kind]
    fat = np.asarray(j_fat_pack(jnp.asarray(table),
                                *(jnp.asarray(s, jnp.float32) for s in state),
                                kind=kind))
    ids = _ids(rng, v, b)
    grads = rng.standard_normal((b, d)).astype(np.float32)
    grads[ids < 0] = 0.0
    return fat, ids, grads


def _j_routed(fat, ids, grads, count, *, kind, d, r):
    b = ids.shape[0]

    @jax.jit
    def run(fat, ids, grads, count):
        seg, ulines, row_lidx, row_slot = jsp.dedupe_rows_and_lines(
            ids, capacity_rows=b, capacity_lines=b, rows_per_line=r)
        lines = jnp.take(fat, jnp.where(ulines < OOB, ulines, 0), axis=0)
        g_u = jax.ops.segment_sum(grads, seg, num_segments=b)
        slots = (count,) if kind == "adam" else ()
        return jsp.fat_apply_routed(
            fat, slots, ulines, g_u, row_lidx, row_slot, lines,
            embedding_dim=d, kind=kind, lr=LR, weight_decay=WD,
            interpret=False)

    return run(jnp.asarray(fat), jnp.asarray(ids), jnp.asarray(grads), count)


def _t_routed(opt, fat, slots, ids, grads, d, r):
    b = ids.shape[0]
    seg, ulines, row_lidx, row_slot = tsp.dedupe_rows_and_lines(
        ids, capacity_rows=b, capacity_lines=b, rows_per_line=r)
    lines = take_fill(fat, torch.where(ulines < OOB, ulines, 0))
    g_u = tsp._segment_sum(grads, seg, b)
    return opt.update_routed(fat, slots, ulines, g_u, row_lidx, row_slot,
                             lines, embedding_dim=d)


@pytest.mark.parametrize("kind,d", [("rowwise_adagrad", 16), ("sgd", 8),
                                    ("adam", 64), ("adagrad", 16)])
def test_fat_apply_routed_matches_jax(kind, d):
    """Two steps (adam's bias correction at t = 1 and 2); adam at d = 64 is
    the R = 1, T = 2 row form, the others pack 2-8 rows a line."""
    rng = np.random.default_rng(31)
    lay = line_layout(d, kind)
    fat, ids, grads = _routed_operands(rng, kind, d)
    opt = tsp.SparseOptimizer(kind=kind, lr=LR, weight_decay=WD)
    tfat = torch.from_numpy(fat.copy())
    tslots = opt.init(tfat)
    jfat, jcount = jnp.asarray(fat), jnp.zeros((), jnp.int32)
    before = tkr.fat_line_update_routed.plain_runs
    launches = tkr.fat_line_update_routed.launches
    for step in range(2):
        g = grads * (1.0 + step)
        jfat, jslots = _j_routed(jfat, ids, g, jcount, kind=kind, d=d, r=lay.r)
        if kind == "adam":
            (jcount,) = jslots
        tfat, tslots = _t_routed(opt, tfat, tslots, torch.from_numpy(ids),
                                 torch.from_numpy(g), d, lay.r)
    assert tkr.fat_line_update_routed.plain_runs == before + 2
    assert tkr.fat_line_update_routed.launches == launches  # no kernel ran
    np.testing.assert_allclose(tfat.numpy(), np.asarray(jfat), rtol=RTOL, atol=ATOL)
    if kind == "adam":
        assert int(tslots[0]) == int(jcount) == 2


@pytest.mark.parametrize("kind,d", [("rowwise_adagrad", 16), ("adam", 16),
                                    ("sgd", 64)])
def test_update_unique_fat_matches_jax(kind, d):
    """``update_unique`` on a fat table (``fat_apply_unique``)."""
    rng = np.random.default_rng(32)
    fat, ids, grads = _routed_operands(rng, kind, d)
    jopt = jsp.SparseOptimizer(kind=kind, lr=LR, weight_decay=WD)
    topt = tsp.SparseOptimizer(kind=kind, lr=LR, weight_decay=WD)

    @jax.jit
    def jrun(fat, ids, grads):
        uids, g, valid = jsp.dedupe_grads(ids, grads)
        return jopt.update_unique(fat, jopt.init(fat), uids, g, valid,
                                  embedding_dim=d)

    jfat, _ = jrun(jnp.asarray(fat), jnp.asarray(ids), jnp.asarray(grads))
    tfat = torch.from_numpy(fat.copy())
    uids, g, valid = tsp.dedupe_grads(torch.from_numpy(ids), torch.from_numpy(grads))
    tfat, _ = topt.update_unique(tfat, topt.init(tfat), uids, g, valid,
                                 embedding_dim=d)
    np.testing.assert_allclose(tfat.numpy(), np.asarray(jfat), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind,d", [("rowwise_adagrad", 16), ("adam", 64),
                                    ("adagrad", 8), ("sgd", 16)])
def test_routed_equals_fat_update_bitwise(kind, d):
    """The same ids and grads through ``fat_update`` (line dedupe, slot-space
    segment-sum, ``fat_line_update``) and through the routed path: the
    same table, bit for bit."""
    rng = np.random.default_rng(33)
    lay = line_layout(d, kind)
    fat, ids, grads = _routed_operands(rng, kind, d)
    opt = tsp.SparseOptimizer(kind=kind, lr=LR, weight_decay=WD)
    a = torch.from_numpy(fat.copy())
    a, sa = opt.update(a, opt.init(a), torch.from_numpy(ids),
                       torch.from_numpy(grads), embedding_dim=d)
    b = torch.from_numpy(fat.copy())
    b, sb = _t_routed(opt, b, opt.init(b), torch.from_numpy(ids),
                      torch.from_numpy(grads), d, lay.r)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not torch.equal(a, torch.from_numpy(fat.copy()))


@pytest.mark.parametrize("kind", ["rowwise_adagrad", "adam"])
def test_routed_plain_leaves_untouched_bitwise(kind):
    """Hand-made routing: a sentinel line holding the sentinel row, a line
    past the table, padding row slots (row_lidx = C) and unnamed slots of
    touched lines.  Only the named slots' [0, need) lanes may change."""
    lay = line_layout(16, kind)
    rng = np.random.default_rng(34)
    n_lines = 12
    fat0 = torch.from_numpy(rng.random((n_lines, lay.tiles, 128)).astype(np.float32))
    ulines = torch.tensor([2, 5, 9, 40, OOB, OOB], dtype=torch.int32)
    # rows: (line slot, slot): two rows share line 2, the sentinel row sits
    # on line slot 4, one row on the out-of-range line, two padding rows
    row_lidx = torch.tensor([0, 0, 1, 2, 3, 4, 6, 6], dtype=torch.int32)
    r = lay.r
    row_slot = torch.tensor([0, r - 1, 1, r // 2, 0, 0, 0, 0], dtype=torch.int32)
    g_u = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    lines = take_fill(fat0, torch.where(ulines < OOB, ulines, 0))
    corr = torch.tensor([0.1, 0.001])
    fat = fat0.clone()
    tkr.fat_line_update_routed_plain(fat, lines, ulines, row_lidx, row_slot,
                                     g_u, corr, layout=lay, lr=0.05,
                                     weight_decay=1e-2)
    changed = (fat_view(fat, lay) != fat_view(fat0, lay))
    named = {(2, 0), (2, r - 1), (5, 1), (9, r // 2)}
    want = torch.zeros_like(changed)
    for line, s in named:
        want[line * lay.r + s, :lay.need] = True
    assert not (changed & ~want).any()
    assert changed.any(dim=1).sum() == len(named)


def test_routed_refusals():
    """int8 byte lines under rowwise_adagrad refuse in the reference's
    words (the other kinds take the row-space int8 update,
    ``test_torch_int8.py``); bf16 tables need bf16 ``lines`` (the
    forward's gather of the table) and then run."""
    lay = line_layout(16, "rowwise_adagrad")
    lines, g_u, corr = torch.zeros((2, 1, 128)), torch.zeros((2, 16)), torch.zeros(2)
    ulines = row_lidx = row_slot = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="storage dtype"):
        tkr.fat_line_update_routed(
            torch.zeros((4, 1, 128), dtype=torch.bfloat16), lines, ulines,
            row_lidx, row_slot, g_u, corr, layout=lay, lr=0.1)
    with pytest.raises(ValueError, match="lines must be"):
        tkr.fat_line_update_routed(
            torch.zeros((4, 1, 128)), torch.zeros((3, 1, 128)), ulines,
            row_lidx, row_slot, g_u, corr, layout=lay, lr=0.1)
    with pytest.raises(ValueError, match="rowwise_adagrad"):
        tsp.fat_apply_routed(torch.zeros((4, 1, 128), dtype=torch.int8), (),
                             ulines, g_u, row_lidx, row_slot, lines,
                             embedding_dim=16, kind="rowwise_adagrad", lr=0.1)
    fb = torch.zeros((4, 1, 128), dtype=torch.bfloat16)
    tsp.fat_apply_routed(fb, (), ulines, torch.ones(2, 16), row_lidx, row_slot,
                         lines.to(torch.bfloat16), embedding_dim=16,
                         kind="rowwise_adagrad", lr=0.1, sr_key=(1, 2))
    assert fb.dtype == torch.bfloat16 and bool((fb[0, 0, :16] != 0).all())
