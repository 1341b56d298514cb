"""Fat-line layout helpers and the plain ``fat_line_update`` of the PyTorch
port against the JAX package.

The JAX side runs its plain reference path (``fat_update(...,
interpret=False)`` -> ``_fat_apply_lines_xla`` on the CPU), which
``tests/test_pallas_kernels.py::TestFatLineUpdate`` already pins to the
Pallas kernel.  Inputs are numpy arrays from a seeded generator.
Tolerances (``tdfo_tpu_torch.interop.TOL``): optimizer math rtol 1e-6 /
atol 1e-7 on touched rows; untouched rows and pad lanes exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdfo_tpu.ops import pallas_kernels as jpk
from tdfo_tpu.ops import sparse as jsp
from tdfo_tpu_torch.interop import TOL
from tdfo_tpu_torch.ops import fat_lines as tfl
from tdfo_tpu_torch.ops import sparse as tsp
from tdfo_tpu_torch.ops.kernels import fat_line_update as tk

KINDS = ("sgd", "adagrad", "rowwise_adagrad", "adam")


@pytest.mark.parametrize("kind", KINDS)
def test_line_layout_geometry(kind):
    for d in (1, 8, 16, 17, 32, 48, 64, 100, 128, 200):
        j, t = jpk.line_layout(d, kind), tfl.line_layout(d, kind)
        assert (t.d, t.kind, t.w, t.r, t.tiles, t.need) == (
            j.d, j.kind, j.w, j.r, j.tiles, j.need), (d, kind)
        assert t.n_lines(1001) == j.n_lines(1001)


def test_line_layout_refuses_narrow_storage():
    """int8 byte lines refuse rowwise_adagrad in the reference's words and
    otherwise have the reference's byte geometry (``test_torch_int8.py``
    holds their bytes); bf16 lines have the reference's (f32) geometry."""
    with pytest.raises(ValueError, match="rowwise_adagrad"):
        tfl.line_layout(16, "rowwise_adagrad", "int8")
    for kind in ("sgd", "adagrad", "adam"):
        j, t = jpk.line_layout(16, kind, jnp.int8), tfl.line_layout(16, kind, "int8")
        assert (t.w, t.r, t.tiles, t.need, t.dtype) == (j.w, j.r, j.tiles, j.need, "int8")
    for kind in KINDS:
        for d in (8, 16, 64, 200):
            j = jpk.line_layout(d, kind, jnp.bfloat16)
            t = tfl.line_layout(d, kind, torch.bfloat16)
            assert (t.d, t.w, t.r, t.tiles, t.need, t.dtype) == (
                j.d, j.w, j.r, j.tiles, j.need, "bfloat16"), (d, kind)
    with pytest.raises(ValueError, match="kind"):
        tfl.line_layout(16, "lamb")


def _state(rng, kind, v, d):
    if kind == "sgd":
        return ()
    if kind == "rowwise_adagrad":
        return (rng.random(v).astype(np.float32),)
    if kind == "adagrad":
        return (rng.random((v, d)).astype(np.float32),)
    return (rng.standard_normal((v, d)).astype(np.float32),
            rng.random((v, d)).astype(np.float32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [16, 64])
def test_pack_unpack_and_gather(kind, d):
    rng = np.random.default_rng(3)
    v = 203  # not a multiple of R: exercises the padded last line
    table = rng.standard_normal((v, d)).astype(np.float32)
    state = _state(rng, kind, v, d)
    j = np.asarray(jpk.fat_pack(jnp.asarray(table),
                                *map(jnp.asarray, state), kind=kind))
    t = tfl.fat_pack(torch.from_numpy(table), *map(torch.from_numpy, state),
                     kind=kind)
    np.testing.assert_array_equal(t.numpy(), j)  # identical bytes
    lay = tfl.line_layout(d, kind)
    for a, b in zip(tfl.fat_unpack(t, lay, rows=v), (table, *state)):
        np.testing.assert_array_equal(a.numpy(), b)
    # negatives clamp to row 0 in both packages
    ids = np.array([0, 5, -3, v - 1, 2, lay.padded_rows(v) - 1], np.int32)
    jr = np.asarray(jpk.fat_gather_rows(jnp.asarray(j), jnp.asarray(ids),
                                        jpk.line_layout(d, kind)))
    tr = tfl.fat_gather_rows(t, torch.from_numpy(ids), lay)
    np.testing.assert_array_equal(tr.numpy(), jr)
    # an id whose line lies past the table reads NaN in both packages (the
    # reference's jnp.take runs in jax's default mode="fill")
    hi = np.array([lay.padded_rows(v) + 3, 10_000, 1, -7], np.int32)
    jr = np.asarray(jpk.fat_gather_rows(jnp.asarray(j), jnp.asarray(hi),
                                        jpk.line_layout(d, kind)))
    tr = tfl.fat_gather_rows(t, torch.from_numpy(hi), lay).numpy()
    np.testing.assert_array_equal(tr, jr)  # NaN == NaN position-wise
    assert np.isnan(tr[:2]).all() and np.isfinite(tr[2:]).all()


def _touched_mask(lay, n_rows, ids):
    """[L*R, W] bool over the rows a batch touches, lanes [0, need)."""
    m = np.zeros((n_rows, lay.w), bool)
    m[np.unique(ids[ids >= 0]), :lay.need] = True
    return m


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [16, 64])
def test_plain_fat_update_matches_jax(kind, d):
    """4 kinds x {d=16 (R > 1, packed form), d=64 (row form, or R=2 for
    sgd)}: duplicate ids, -1 padding, shared lines with untouched slots."""
    rng = np.random.default_rng(11 + d)
    v, b, lr, wd = 300, 96, 0.05, 1e-2
    lay = tfl.line_layout(d, kind)
    table = rng.standard_normal((v, d)).astype(np.float32)
    state = _state(rng, kind, v, d)
    ids = rng.integers(0, v, b).astype(np.int32)
    ids[::7] = ids[1::7][: len(ids[::7])]  # guaranteed duplicates
    ids[5::11] = -1  # padding
    grads = rng.standard_normal((b, d)).astype(np.float32)
    j_fat = jpk.fat_pack(jnp.asarray(table), *map(jnp.asarray, state), kind=kind)
    t_fat = torch.from_numpy(np.array(j_fat))
    t0 = t_fat.clone()
    j_slots = (jnp.asarray(2, jnp.int32),) if kind == "adam" else ()
    t_slots = (torch.tensor(2, dtype=torch.int32),) if kind == "adam" else ()

    j_new, _ = jax.jit(functools.partial(
        jsp.fat_update, embedding_dim=d, kind=kind, lr=lr, weight_decay=wd,
        interpret=False))(j_fat, j_slots, jnp.asarray(ids), jnp.asarray(grads))
    before = tk.fat_line_update.plain_runs
    launches = tk.fat_line_update.launches
    t_new, t_slots2 = tsp.fat_update(t_fat, t_slots, torch.from_numpy(ids),
                                     torch.from_numpy(grads), embedding_dim=d,
                                     kind=kind, lr=lr, weight_decay=wd)
    assert tk.fat_line_update.plain_runs == before + 1  # one wrapper call
    assert tk.fat_line_update.launches == launches  # no kernel ran
    assert t_new is t_fat  # in place
    if kind == "adam":
        assert int(t_slots2[0]) == 3

    got = t_new.numpy().reshape(-1, lay.w)
    want = np.asarray(j_new).reshape(-1, lay.w)
    m = _touched_mask(lay, got.shape[0], ids)
    np.testing.assert_array_equal(got[~m], want[~m])
    np.testing.assert_array_equal(got[~m], t0.numpy().reshape(-1, lay.w)[~m])
    rtol, atol = TOL["optimizer"]
    np.testing.assert_allclose(got[m], want[m], rtol=rtol, atol=atol)
    assert not np.array_equal(got[m], t0.numpy().reshape(-1, lay.w)[m])


@pytest.mark.parametrize("kind", KINDS)
def test_plain_kernel_operands_match_xla_formulation(kind):
    """``fat_line_update_plain`` on explicit packed operands (sentinel and
    out-of-range lines, untouched shared-line slots) against the JAX
    package's ``_fat_apply_lines_xla`` on the same operands."""
    rng = np.random.default_rng(5)
    d, n_lines = 16, 12
    lay = tfl.line_layout(d, kind)
    v = n_lines * lay.r
    fat = np.asarray(jpk.fat_pack(
        jnp.asarray(rng.standard_normal((v, d)).astype(np.float32)),
        *map(jnp.asarray, _state(rng, kind, v, d)), kind=kind))
    # line 12 is past the table; negative line ids are outside both
    # packages' contract (the XLA formulation would wrap them)
    ul = np.array([3, 2**31 - 1, 7, 12, 0, 9], np.int32)
    g = rng.standard_normal((6, lay.r, d)).astype(np.float32)
    tl = (rng.random((6, lay.r)) > 0.4).astype(np.float32)
    tl[0] = 1.0
    corr = np.array([1 - 0.9**3, 1 - 0.999**3], np.float32)
    kw = dict(lr=0.05, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    want = np.asarray(jax.jit(functools.partial(
        jsp._fat_apply_lines_xla, layout=jpk.line_layout(d, kind), **kw))(
        jnp.asarray(fat), jnp.asarray(ul), jnp.asarray(g.reshape(-1, d)),
        jnp.asarray(tl.reshape(-1)), new_count=jnp.asarray(3, jnp.int32)))
    t = torch.from_numpy(fat.copy())
    tk.fat_line_update_plain(t, torch.from_numpy(ul), torch.from_numpy(g),
                             torch.from_numpy(tl), torch.from_numpy(corr),
                             layout=lay, **kw)
    rtol, atol = TOL["optimizer"]
    np.testing.assert_allclose(t.numpy(), want, rtol=rtol, atol=atol)
    view0, view1 = fat.reshape(-1, lay.w), t.numpy().reshape(-1, lay.w)
    for u, line in enumerate(ul):
        for s in range(lay.r):
            row = int(line) * lay.r + s
            if 0 <= line < n_lines and tl[u, s] > 0:
                np.testing.assert_array_equal(view1[row, lay.need:],
                                              view0[row, lay.need:])
            elif 0 <= line < n_lines:
                np.testing.assert_array_equal(view1[row], view0[row])
    untouched = [ln for ln in range(n_lines) if ln not in ul]
    np.testing.assert_array_equal(t.numpy()[untouched], fat[untouched])


def test_wrapper_rejects_bad_operands():
    lay = tfl.line_layout(64, "adam")
    fat = torch.zeros((4, lay.tiles, 128))
    ul = torch.tensor([0, 1], dtype=torch.int32)
    corr = torch.ones(2)
    with pytest.raises(ValueError, match="ulines"):
        tk.fat_line_update(fat, ul.long(), torch.zeros(2, 64), None, corr,
                           layout=lay, lr=0.1)
    with pytest.raises(ValueError, match="g must be"):
        tk.fat_line_update(fat, ul, torch.zeros(2, 32), None, corr,
                           layout=lay, lr=0.1)
    # a bf16 CPU table runs the plain version (bf16 branch)
    before = tk.fat_line_update.plain_runs
    fb = fat.to(torch.bfloat16)
    tk.fat_line_update(fb, ul, torch.ones(2, 64), None, corr, layout=lay,
                       lr=0.1, sr_seed=7)
    assert tk.fat_line_update.plain_runs == before + 1
    assert fb.dtype == torch.bfloat16 and bool((fb[:2, 0, :64] != 0).all())
