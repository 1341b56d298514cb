"""int8 rowwise storage of the PyTorch port against ``tdfo_tpu``: the
threefry uniform, ``quantize_rows`` / ``dequantize_rows``, the byte
helpers, the int8 write of the row-sparse tiers, the ``sparse_*`` kinds on
int8 tables, the int8 byte-container fat lines (layout, pack, unpack,
gather, the row-space update) and the int8 casts' confinement to
``ops/quant.py``.

Held bitwise: the uniform draw, the codes and sidecar ``quantize_rows``
writes for the same f32 rows and key (keyed and unkeyed), the decode, the
byte views, fat-line bytes, and every port-internal contract (the fused
int8 update equals the plain int8 update, whichever entry point).  The
composed optimizer steps hold their codes bitwise and their f32 sidecars
and optimizer state to the optimizer rung of the ladder (``TOL
["optimizer"]``): XLA's CPU backend contracts the reference's f32
multiply-adds into fused multiply-adds, one rounding where the port's
eager ops round twice, so those f32 values can differ in the last bit.
The JAX side runs jitted, as the reference's own tests run it."""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdfo_tpu.ops import pallas_kernels as jpk
from tdfo_tpu.ops import quant as jq
from tdfo_tpu.ops import sparse as jsp
from tdfo_tpu_torch.interop import TOL, to_torch
from tdfo_tpu_torch.ops import fat_lines as tfl
from tdfo_tpu_torch.ops import quant as tq
from tdfo_tpu_torch.ops import sparse as tsp
from tdfo_tpu_torch.ops import threefry as tf

RTOL, ATOL = TOL["optimizer"]
KINDS = ("sgd", "adagrad", "rowwise_adagrad", "adam")
V, D, B = 60, 8, 48


def _bits(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _rows(rng, n, d=D):
    x = (rng.standard_normal((n, d)) * rng.random((n, 1)) * 4
         + rng.standard_normal((n, 1))).astype(np.float32)
    x[1] = 0.25  # constant rows: scale 1, the offset carries the value
    x[2] = 0.0
    return x


def _ids(rng, v=V - 6, b=B):
    ids = rng.integers(0, v, b).astype(np.int32)
    ids[::7] = -1  # padding
    ids[1::9] = ids[2::9][: len(ids[1::9])]  # duplicates
    return ids


def test_uniform_matches_jax():
    """[0, 1) (the stochastic rounding's draw) against the jitted
    reference; a scaled range against jax's op-by-op evaluation."""
    want = jax.jit(functools.partial(jax.random.uniform, shape=(7, 5)))(
        jax.random.PRNGKey(0))
    got = tf.uniform(tf.PRNGKey(0), (7, 5))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    want = jax.random.uniform(jax.random.PRNGKey(11), (300,), minval=-0.3,
                              maxval=0.7)
    got = tf.uniform(tf.PRNGKey(11), (300,), -0.3, 0.7)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("keyed", [False, True], ids=["rtn", "sr"])
def test_quantize_rows_matches_jax(keyed):
    rng = np.random.default_rng(1)
    x = _rows(rng, 40)
    jk, tk = ((jq.sr_key(5, "t"), tq.sr_key(5, "t")) if keyed else (None, None))
    jd, js = jax.jit(lambda a: jq.quantize_rows(a, jk))(x)
    td, ts = tq.quantize_rows(torch.from_numpy(x), tk)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    # constant rows: scale 1, code -128, the offset carries the value
    assert (td[1:3] == -128).all() and (ts[1:3, 0] == 1.0).all()
    want = jax.jit(jq.dequantize_rows)(jd, js)
    np.testing.assert_array_equal(_bits(tq.dequantize_rows(td, ts).numpy()), _bits(want))
    # the host (numpy) decode is the same numbers
    np.testing.assert_array_equal(
        _bits(tq.dequantize_rows(np.asarray(jd), np.asarray(js))), _bits(want))
    # round to nearest lands within half a grid step, SR within one
    err = np.abs(tq.dequantize_rows(td, ts).numpy() - x)
    assert (err <= (0.5 if not keyed else 1.0) * ts[:, :1].numpy() + 1e-6).all()


def test_byte_helpers_match_jax_and_quantize_refuses_int8():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 3)).astype(np.float32)
    b = tq.f32_to_bytes(torch.from_numpy(x))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jax.jit(jq.f32_to_bytes)(x)))
    np.testing.assert_array_equal(_bits(tq.bytes_to_f32(b).numpy()), _bits(x))
    with pytest.raises(ValueError, match="multiple of 4"):
        tq.bytes_to_f32(b[:, :5])
    assert tq.storage_dtype("int8") == torch.int8
    with pytest.raises(ValueError, match="quantize_rows/dequantize_rows"):
        tq.quantize(torch.from_numpy(x), "int8")


def test_int8_write_matches_jax_bitwise():
    """The int8 write of every row-sparse tier: the same f32 rows, uids and
    key requantize over the whole [C, d] block (sentinel slots included)
    and scatter codes and sidecar rows, bit for bit the reference's
    ``_requantize_scatter``."""
    rng = np.random.default_rng(3)
    codes, qs = map(np.asarray, jax.jit(jq.quantize_rows)(_rows(rng, V)))
    uids, _, valid = jax.jit(jsp.dedupe_grads)(
        jnp.asarray(_ids(rng)), jnp.zeros((B, D)))
    new = _rows(rng, B)
    jt, jqs = jax.jit(lambda t, q, u, n, v: jsp._requantize_scatter(
        t, q, u, n, v, jq.sr_key(2, "t")))(codes, qs, uids, new, valid)
    tt, tqs = to_torch(codes), to_torch(qs)
    tsp._scatter_rows(tt, to_torch(uids), to_torch(valid), torch.from_numpy(new),
                      tq.sr_key(2, "t"), tqs)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(_bits(tqs.numpy()), _bits(jqs))


def _int8_table(rng, v=V):
    codes, qs = jax.jit(jq.quantize_rows)(_rows(rng, v))
    return np.asarray(codes), np.asarray(qs)


def _slots(opt, codes, rng):
    """Non-zero optimizer state (adam's count 3) for both packages."""
    out = []
    for s in opt.init(jnp.asarray(codes)):
        out.append(np.asarray(s) + 3 if s.ndim == 0
                   else rng.random(s.shape).astype(np.float32))
    return out


def test_sparse_int8_matches_jax():
    """``SparseOptimizer.update`` of each kind on a plain int8 table with
    its sidecar: codes bitwise, sidecar and slots at the optimizer rung,
    untouched rows bitwise unchanged.  The adam table is below the
    small-vocab threshold: int8 stays on the row path in both packages.
    One jitted program runs the four kinds on the JAX side."""
    rng = np.random.default_rng(4)
    codes, qs = _int8_table(rng)
    jopts = {k: jsp.sparse_optimizer(k, lr=0.05, weight_decay=1e-2) for k in KINDS}
    slots = {k: tuple(_slots(o, codes, rng)) for k, o in jopts.items()}
    ids, g = _ids(rng), rng.standard_normal((B, D)).astype(np.float32)
    want = jax.jit(lambda t, s, q, i, gg: {
        k: o.update(t, s[k], i, gg, qscale=q, sr_key=jq.sr_key(3, "t"))
        for k, o in jopts.items()})(codes, slots, qs, ids, g)
    untouched = np.setdiff1d(np.arange(V), ids[ids >= 0])
    for kind in KINDS:
        to = tsp.sparse_optimizer(kind, lr=0.05, weight_decay=1e-2)
        tt, ts, tqs = to.update(to_torch(codes), tuple(map(to_torch, slots[kind])),
                                torch.from_numpy(ids), torch.from_numpy(g),
                                qscale=to_torch(qs), sr_key=tq.sr_key(3, "t"))
        jt, js, jqs = want[kind]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=kind)
        np.testing.assert_allclose(tqs.numpy(), np.asarray(jqs), rtol=RTOL,
                                   atol=ATOL, err_msg=kind)
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL, err_msg=kind)
        np.testing.assert_array_equal(tt.numpy()[untouched], codes[untouched])
        np.testing.assert_array_equal(_bits(tqs.numpy()[untouched]),
                                      _bits(qs[untouched]))


@pytest.mark.parametrize("kind,d", [("sgd", 8), ("adagrad", 16), ("adam", 64)],
                         ids=["R8", "R1", "tiles3"])
def test_fat_int8_layout_pack_gather_match_jax(kind, d):
    rng = np.random.default_rng(5)
    v = 37
    n_state = {"sgd": 0, "adagrad": 1, "adam": 2}[kind]
    table = _rows(rng, v, d)
    state = [rng.standard_normal((v, d)).astype(np.float32) for _ in range(n_state)]
    jl, tl = jpk.line_layout(d, kind, "int8"), tfl.line_layout(d, kind, "int8")
    assert (tl.w, tl.r, tl.tiles, tl.need, tl.dtype) == (jl.w, jl.r, jl.tiles, jl.need, "int8")
    ids = rng.integers(-2, v, (4, 9))

    def pack_gather(a, i, *s):
        f = jpk.fat_pack(a, *s, kind=kind, dtype=jnp.int8)
        return f, jpk.fat_gather_rows(f, i, jl)

    jf, want = jax.jit(pack_gather)(table, ids, *state)
    jf = np.asarray(jf)
    tfat = tfl.fat_pack(torch.from_numpy(table), *map(torch.from_numpy, state),
                        kind=kind, dtype="int8")
    np.testing.assert_array_equal(tfat.numpy(), jf)
    for a, b in zip(tfl.fat_unpack(tfat, tl, rows=v), jpk.fat_unpack(jnp.asarray(jf), jl, rows=v)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    # packing codes with their sidecar gives the same bytes
    codes, qs = tq.quantize_rows(torch.from_numpy(table))
    again = tfl.fat_pack(codes, *map(torch.from_numpy, state), kind=kind,
                         dtype="int8", qscale=qs)
    assert torch.equal(again, tfat)
    got = tfl.fat_gather_rows(tfat, torch.from_numpy(ids), tl)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_fat_int8_rowwise_refuses_in_both():
    with pytest.raises(ValueError, match="rowwise_adagrad") as te:
        tfl.line_layout(16, "rowwise_adagrad", "int8")
    with pytest.raises(ValueError, match="rowwise_adagrad") as je:
        jpk.line_layout(16, "rowwise_adagrad", "int8")
    assert str(te.value) == str(je.value)


def _fat_case(kind, rng, d=16, v=90):
    """A fused int8 table and its plain twin (codes, sidecar, f32 state)
    holding the same rows, plus one step's ids and grads."""
    n_state = {"sgd": 0, "adagrad": 1, "adam": 2}[kind]
    codes, qs = tq.quantize_rows(torch.from_numpy(_rows(rng, v, d)))
    state = [torch.from_numpy(rng.random((v, d)).astype(np.float32))
             for _ in range(n_state)]
    fat = tfl.fat_pack(codes, *state, kind=kind, dtype="int8", qscale=qs)
    ids = torch.from_numpy(_ids(rng, v - 4, 64))
    g = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32))
    return codes, qs, state, fat, ids, g


@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
def test_fat_int8_equals_plain_int8(kind):
    """The reference's contract, held in the port bitwise: the fused int8
    update (``fat_update``, ``fat_apply_unique`` and the routed form the
    dedup step calls) writes the codes, sidecars and state the plain int8
    update writes, for the same ids and key."""
    d = 16
    rng = np.random.default_rng(6)
    codes, qs, state, fat, ids, g = _fat_case(kind, rng, d)
    lay = tfl.line_layout(d, kind, "int8")
    opt = tsp.sparse_optimizer(kind, lr=0.05, weight_decay=1e-2,
                               small_vocab_threshold=0)
    key = tq.sr_key(4, "t")
    count = [torch.tensor(2, dtype=torch.int32)] if kind == "adam" else []
    plain_slots = (*state, *count) if kind != "adagrad" else tuple(state)
    if kind == "sgd":
        plain_slots = ()
    pt, ps, pq = opt.update(codes.clone(), tuple(s.clone() for s in plain_slots),
                            ids, g, qscale=qs.clone(), sr_key=key)
    want = tfl.fat_pack(pt, *(ps[:2] if kind == "adam" else ps), kind=kind,
                        dtype="int8", qscale=pq)
    fat_slots = lambda: tuple(c.clone() for c in count)  # noqa: E731
    f1, s1 = opt.update(fat.clone(), fat_slots(), ids, g, embedding_dim=d, sr_key=key)
    assert torch.equal(f1, want)
    uids, gu, valid = tsp.dedupe_grads(ids, g)
    f2, _ = opt.update_unique(fat.clone(), fat_slots(), uids, gu, valid,
                              embedding_dim=d, sr_key=key)
    assert torch.equal(f2, want)
    seg, ulines, row_lidx, row_slot = tsp.dedupe_rows_and_lines(
        ids, capacity_rows=64, capacity_lines=64, rows_per_line=lay.r)
    g_u = tsp._segment_sum(g, seg, 64)
    f3, s3 = opt.update_routed(fat.clone(), fat_slots(), ulines, g_u, row_lidx,
                               row_slot, None, embedding_dim=d, sr_key=key)
    assert torch.equal(f3, want)
    if kind == "adam":
        assert int(s1[0]) == int(s3[0]) == int(ps[2]) == 3


def test_fat_int8_matches_jax():
    """``_fat_apply_int8`` of each kind against the reference's (one jitted
    program): codes bitwise, the rest of each touched slot (sidecar and
    state bytes, decoded) at the optimizer rung, every untouched byte
    unchanged."""
    d = 16
    rng = np.random.default_rng(7)
    kw = dict(lr=0.05, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
    cases = {}
    for kind in ("sgd", "adagrad", "adam"):
        _, _, _, fat, ids, g = _fat_case(kind, rng, d)
        uids, gu, _ = tsp.dedupe_grads(ids, g)
        count = (np.int32(5),) if kind == "adam" else ()
        cases[kind] = (fat, uids, gu, count)

    def run(ops):
        return {k: jsp._fat_apply_int8(
            f, c, u, gg, layout=jpk.line_layout(d, k, "int8"),
            sr_key=jq.sr_key(6, "t"), **kw)[0] for k, (f, u, gg, c) in ops.items()}

    want = jax.jit(run)({k: (f.numpy(), u.numpy(), gu.numpy(), c)
                         for k, (f, u, gu, c) in cases.items()})
    for kind, (fat, uids, gu, count) in cases.items():
        lay, jlay = tfl.line_layout(d, kind, "int8"), jpk.line_layout(d, kind, "int8")
        tfat, _ = tsp._fat_apply_int8(fat.clone(), tuple(torch.tensor(c) for c in count),
                                      uids, gu, layout=lay,
                                      sr_key=tq.sr_key(6, "t"), **kw)
        got = tfl.fat_unpack(tfat, lay)
        exp = jpk.fat_unpack(jnp.asarray(want[kind]), jlay)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(exp[0]), err_msg=kind)
        for a, b in zip(got[1:], exp[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL, err_msg=kind)
        touched = np.zeros(tfl.fat_view(tfat, lay).shape[0], bool)
        touched[uids[uids < tsp.SENTINEL].numpy()] = True
        np.testing.assert_array_equal(tfl.fat_view(tfat, lay)[~touched].numpy(),
                                      tfl.fat_view(fat, lay)[~touched].numpy())


def test_no_int8_casts_outside_quant_module():
    """``tdfo_tpu_torch/ops/quant.py`` owns the int8 grid (the port's
    mirror of ``tests/test_quality.py::test_no_int8_casts_outside_quant_module``):
    a ``.to(torch.int8)`` / ``.view(torch.int8)`` / ``.type(torch.int8)``
    anywhere else would mint codes without their sidecar.  Casts from int8
    and host-side ``np.int8`` stay legal.  Self-tested on a synthetic
    offender."""
    import tdfo_tpu_torch

    root = Path(tdfo_tpu_torch.__file__).parent
    sanctioned = root / "ops" / "quant.py"

    def names_int8(node):
        if isinstance(node, ast.Constant):
            return node.value == "int8"
        return (isinstance(node, ast.Attribute) and node.attr == "int8"
                and isinstance(node.value, ast.Name) and node.value.id == "torch")

    def int8_cast_lines(tree):
        hits = []
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("to", "view", "type")):
                continue
            operands = list(node.args) + [k.value for k in node.keywords]
            if any(names_int8(a) for a in operands):
                hits.append(node.lineno)
        return hits

    synthetic = "import torch\ndef sneak(x):\n    return x.to(dtype=torch.int8)\n"
    assert int8_cast_lines(ast.parse(synthetic)) == [3]
    offenders, sanctioned_hits = [], 0
    for path in sorted(root.rglob("*.py")):
        lines = int8_cast_lines(ast.parse(path.read_text(), filename=str(path)))
        if path == sanctioned:
            sanctioned_hits += len(lines)
            continue
        offenders += [f"{path}:{ln}" for ln in lines]
    assert sanctioned_hits > 0  # the scanner sees quantize_rows' cast
    assert not offenders, (
        "cast to int8 outside tdfo_tpu_torch/ops/quant.py: " + ", ".join(offenders))
