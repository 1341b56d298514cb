"""The update cache of the PyTorch port (``SparseOptimizer.cache_*``,
``cache_route``, the step's cached tier and the trainer's flush cadence)
against ``tdfo_tpu`` and against the port's own uncached path.

Held exactly: the live directory entries (sorted ids), the admission
overflow counts, and, in the port, a cached run against the uncached run
(every table, sidecar and slot bit for bit after the flush: the cached
math is the ``sparse_*`` math and the flush copies bits), int8 caches
included.  Against JAX, the cached rows, mirrors and flushed tables sit at
the ladder (int8 codes bitwise): XLA fuses
the reference's f32 multiply-adds, the port's eager ops round each.  The
physical slot a new id takes depends on the order of the free directory
entries, which the reference leaves to an unstable sort, so rows are
compared through the directory, id by id.  Several steps of optimizer
math put the f32 values on the trajectory rung (``TOL["trajectory"]``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdfo_tpu.ops import quant as jq
from tdfo_tpu.ops import sparse as jsp
from tdfo_tpu_torch.interop import TOL, to_torch, tree_from_numpy
from tdfo_tpu_torch.ops import quant as tq
from tdfo_tpu_torch.ops import sparse as tsp

RTOL, ATOL = TOL["trajectory"]
KINDS = ("sgd", "adagrad", "rowwise_adagrad", "adam")
V, D, B, C, STEPS, FLUSH_AT = 120, 8, 32, 256, 3, 1


def _batches(seed, v=V, b=B, steps=STEPS):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = rng.integers(0, v, b).astype(np.int32)
        ids[::9] = -1
        out.append((ids, rng.standard_normal((b, D)).astype(np.float32)))
    return out


def _table(int8, seed=0):
    x = np.random.default_rng(seed).standard_normal((V, D)).astype(np.float32)
    if not int8:
        return x, None
    codes, qs = jax.jit(jq.quantize_rows)(x)
    return np.asarray(codes), np.asarray(qs)


def _jax_run(kinds, int8, batches, c=C):
    """K cached steps with a flush after step FLUSH_AT and at the end, for
    each kind (one jitted step and one jitted flush per kind, reused):
    ``{kind: (cache before the last flush, table, slots, qscale,
    overflows)}``."""
    table, qs = _table(int8)
    out = {}
    for kind in kinds:
        opt = jsp.sparse_optimizer(kind, lr=0.05, weight_decay=1e-2)
        upd = jax.jit(lambda cache, t, s, q, ids, g, i, opt=opt: opt.cache_update(
            cache, t, s, ids, g, step=i, qscale=q,
            sr_key=jq.sr_key(i, "t") if int8 else None))
        flush = jax.jit(opt.cache_flush)
        t, q = jnp.asarray(table), None if qs is None else jnp.asarray(qs)
        s = opt.init(t)
        cache, overs = opt.cache_init(t, c), []
        for i, (ids, g) in enumerate(batches):
            cache, s = upd(cache, t, s, q, ids, g, jnp.int32(i))
            if i == FLUSH_AT or i == len(batches) - 1:
                last = cache
                r = flush(cache, t, s, q)
                cache, t, s = r[0], r[1], r[2]
                q = r[3] if int8 else q
                overs.append(r[-1])
        out[kind] = (last, t, s, q, overs)
    return out


def _port_run(kind, int8, batches, cached=True, c=C):
    table, qs = _table(int8)
    opt = tsp.sparse_optimizer(kind, lr=0.05, weight_decay=1e-2)
    t = to_torch(table)
    q = None if qs is None else to_torch(qs)
    s = opt.init(t)
    cache, overs, last = opt.cache_init(t, c), [], None
    for i, (ids, g) in enumerate(batches):
        key = tq.sr_key(i, "t") if int8 else None
        ids, g = torch.from_numpy(ids), torch.from_numpy(g)
        if not cached:
            opt.update(t, s, ids, g, qscale=q, sr_key=key)
            continue
        cache, s = opt.cache_update(cache, t, s, ids, g, step=i, qscale=q,
                                    sr_key=key)
        if i == FLUSH_AT or i == len(batches) - 1:
            last = cache
            r = opt.cache_flush(cache, t, s, q)
            cache = r[0]
            overs.append(int(r[-1]))
    return last, t, s, q, overs


def _entries(cache):
    """``{id: {field: row}}`` of the live directory entries."""
    ids = np.asarray(cache["ids"])
    slot = np.asarray(cache["slot"])
    live = ids < 2**31 - 1
    fields = [k for k in ("rows", "qs", "acc", "mu", "nu", "freq", "last", "dirty")
              if k in cache]
    return {int(i): {k: np.asarray(cache[k])[p] for k in fields}
            for i, p in zip(ids[live], slot[live])}


def _close(a, b, what):
    """Integers and int8 codes exactly; f32 values at the trajectory rung
    (several steps of optimizer math)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype in (np.int8, np.int32, np.bool_):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("int8,kinds", [
    (False, ("adagrad", "rowwise_adagrad")), (True, ("sgd", "adam"))],
    ids=["f32", "int8"])
def test_cache_steps_and_flush_match_jax(int8, kinds):
    """Three cached steps with a flush after the second and at the end
    (each kind once against JAX; every kind and dtype is held to the
    uncached run below): the directory's live ids exactly, each live
    entry's row, mirrors and counters (int8: codes and the ``qs`` grid
    mirror), the flushed table, sidecar and slots, and the overflow counts
    (0)."""
    batches = _batches(1)
    want = _jax_run(kinds, int8, batches)
    for kind in kinds:
        jc, jt, js, jqs, jover = want[kind]
        tc, tt, ts, tqs, tover = _port_run(kind, int8, batches)
        assert tover == [int(o) for o in jover] == [0, 0], kind
        je, te = _entries(jc), _entries(tc)
        assert sorted(te) == sorted(je) and len(te) > B, kind
        for i in te:
            for k in te[i]:
                _close(te[i][k], je[i][k], f"{kind} id {i} {k}")
        _close(tt.numpy(), jt, f"{kind} table")
        if int8:
            _close(tqs.numpy(), jqs, f"{kind} sidecar")
        for a, b in zip(ts, js):
            _close(a.numpy(), b, f"{kind} slot")


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_cached_run_equals_uncached_run(int8):
    """The reference's contract held bitwise in the port: after the flush
    the cached tables, sidecars and slots equal the uncached run's."""
    batches = _batches(2, steps=5)
    for kind in KINDS:
        _, ct, cs, cq, overs = _port_run(kind, int8, batches)
        _, ut, us, uq, _ = _port_run(kind, int8, batches, cached=False)
        assert overs == [0, 0]
        assert torch.equal(ct, ut), kind
        assert cq is None or torch.equal(cq, uq), kind
        for a, b in zip(cs, us):
            assert torch.equal(a, b), kind


def test_overflow_counts_match_jax():
    """A cache too small for the interval's distinct rows: the same ids are
    admitted and the same number overflow in both packages (the trainer
    then refuses to go on: ``test_trainer_refuses_overflow``)."""
    batches = _batches(3, steps=3)
    (jc, _, _, _, jover), = _jax_run(("sgd",), False, batches, c=40).values()
    tc, _, _, _, tover = _port_run("sgd", False, batches, c=40)
    assert tover == [int(o) for o in jover] and tover[0] > 0
    assert sorted(_entries(tc)) == sorted(_entries(jc))


def test_cache_route_and_overlay():
    """Routing through the directory (negative and absent ids miss) and
    the overlay serve the cached value, f32 and int8 decoded."""
    opt = tsp.sparse_optimizer("sgd", lr=0.1)
    for int8 in (False, True):
        table, qs = _table(int8)
        t = to_torch(table)
        q = None if qs is None else to_torch(qs)
        cache = opt.cache_init(t, 16)
        ids = torch.tensor([5, 9, -1, 5])
        g = torch.ones((4, D))
        cache, _ = opt.cache_update(cache, t, (), ids, g, step=0, qscale=q,
                                    sr_key=tq.sr_key(0, "t") if int8 else None)
        phys, hit = tsp.cache_route(cache, torch.tensor([[5, 7], [-1, 9]]))
        assert hit.tolist() == [[True, False], [False, True]]
        assert (phys[~hit] == 16).all()
        rows = torch.zeros((2, D))
        got = tsp.cache_overlay_rows(cache, torch.tensor([9, 3]), rows)
        want, _ = tsp.cache_lookup_rows(cache, torch.tensor([9]))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], rows[1])
        if int8:
            assert cache["rows"].dtype == torch.int8 and "qs" in cache


def test_cache_state_rides_snapshots():
    """The caches ride the slots: a snapshot/restore brings them back
    bitwise (checkpoints: the trainer's resume test), and JAX-made caches
    carry over through ``interop.tree_from_numpy`` with the reference's
    keys."""
    from tdfo_tpu_torch.train.sparse_step import SparseTrainState

    table, qs = _table(True)
    opt = tsp.sparse_optimizer("adam", lr=0.01)
    jcache = jax.jit(lambda t: jsp.sparse_optimizer("adam", lr=0.01).cache_init(
        t, 32))(table)
    cache = tree_from_numpy(jax.tree.map(np.asarray, jcache))
    assert cache.keys() == opt.cache_init(to_torch(table), 32).keys()
    state = SparseTrainState.create(
        backbone=torch.nn.Linear(1, 1),
        tables={"t": to_torch(table), "__qscale__/t": to_torch(qs)},
        sparse_opt=opt, learning_rate=0.0, weight_decay=0.0)
    assert state.slots["__qscale__/t"] == ()
    state.slots["__cache__/t"], _ = opt.cache_update(
        cache, state.tables["t"], state.slots["t"], torch.tensor([3, 4]),
        torch.ones((2, D)), step=0, qscale=state.tables["__qscale__/t"],
        sr_key=tq.sr_key(0, "t"))
    snap = state.snapshot()
    saved = {k: v.clone() for k, v in state.slots["__cache__/t"].items()}
    state.slots["__cache__/t"]["rows"].zero_()
    state.slots["__cache__/t"]["ids"].fill_(7)
    state.restore(snap)
    for k, v in saved.items():
        assert torch.equal(state.slots["__cache__/t"][k], v), k
