"""Delta bundles and the bundle store of the port (``tdfo_tpu_torch/serve/
export.py::export_delta`` / ``apply_delta_arrays``, ``serve/swap.py``)
against ``tdfo_tpu``'s, on the CPU.

* The same numpy tables and dense parameters (a DMP TwoTower with a fat
  stack) go through both packages' ``export_delta``: the delta directories
  and digests are bitwise the reference's, with and without a touched
  hint; the composed bundle equals the full export of the new state.
* ``apply_delta_arrays`` and the chain refusals (gap, re-order, parent
  digest, corrupt payload, result digest, schema drift, stale hint) refuse
  with the reference's exception and words.
* The same sequence of ``BundleStore`` operations (ingest, apply, canary
  publish / rollback / promote, a crash left at each recovery point then
  ``recover``, the retention sweep) leaves pointers, manifests, arrays and
  records byte-identical to the reference's store (record times aside).
* ``kill_during_swap`` in a child process: the apply dies between stage and
  publish; a restart recovers to the last verified version and re-applies
  to the reference store's bytes.
"""

import functools
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_serve_helpers import (
    assert_same_bundle,
    jax_twotower,
    port_twotower,
    twotower_export_kw,
)

from tdfo_tpu.serve import export as jexp
from tdfo_tpu.serve import swap as jswap
from tdfo_tpu.utils import faults as jfaults
from tdfo_tpu_torch.serve import export as texp
from tdfo_tpu_torch.serve import swap as tswap
from tdfo_tpu_torch.utils import faults as tfaults

FUSED = 200  # user (300 rows) and item (260) in one fat stack


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jfaults.configure(None)
    tfaults.configure(None)


@functools.lru_cache(maxsize=None)
def _base():
    jc, _, jt, jd = jax_twotower(fused_threshold=FUSED, seed=3)
    import jax

    return jc, {k: np.asarray(v) for k, v in jt.items()}, jax.tree.map(np.asarray, jd)


def _bumped(tables, dense, seed, rows=5):
    """A new state: ``rows`` random rows (fat lines: whole lines) of every
    array and one dense leaf moved."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in tables.items():
        v = v.copy()
        idx = rng.choice(v.shape[0], min(rows, v.shape[0]), replace=False)
        v[idx] += rng.standard_normal(v[idx].shape).astype(v.dtype)
        out[k] = v
    import jax

    dense = jax.tree.map(np.array, dense)
    jax.tree.leaves(dense)[0][...] += np.float32(0.5)
    return out, dense


def _export(pkg, out, tables, dense, **kw):
    jc = _base()[0]
    if pkg == "jax":
        import jax.numpy as jnp

        return jexp.export_bundle(out, coll=jc, tables={k: jnp.asarray(v) for k, v
                                                        in tables.items()},
                                  dense_params=dense, **dict(twotower_export_kw(), **kw))
    tc, tt, tb = port_twotower(tables, dense, fused_threshold=FUSED)
    return texp.export_bundle(out, coll=tc, tables=tt, dense_params=tb,
                              **dict(twotower_export_kw(), **kw))


def _delta(pkg, out, base_dir, tables, dense, **kw):
    jc = _base()[0]
    if pkg == "jax":
        import jax.numpy as jnp

        return jexp.export_delta(out, base_dir, coll=jc,
                                 tables={k: jnp.asarray(v) for k, v in tables.items()},
                                 dense_params=dense, **dict(twotower_export_kw(), **kw))
    tc, tt, tb = port_twotower(tables, dense, fused_threshold=FUSED)
    return texp.export_delta(out, base_dir, coll=tc, tables=tt, dense_params=tb,
                             **dict(twotower_export_kw(), **kw))


def _changed_rows(tables1):
    """The exact touched hint: per logical table, the rows whose values
    moved from the base (the port's merged view)."""
    tc, tt0, _ = port_twotower(*_base()[1:], fused_threshold=FUSED)
    _, tt1, _ = port_twotower(tables1, _base()[2], fused_threshold=FUSED)
    a, b = texp.merged_tables(tc, tt0), texp.merged_tables(tc, tt1)
    return {n: np.nonzero(np.any(a[n] != b[n], axis=1))[0] for n in a}


@pytest.mark.parametrize("hint", [False, True], ids=["no_hint", "hint"])
def test_delta_is_the_reference_delta(tmp_path, hint):
    _, t0, d0 = _base()
    t1, d1 = _bumped(t0, d0, seed=1)
    kw = {"touched": _changed_rows(t1)} if hint else {}
    dirs = {}
    for pkg in ("jax", "port"):
        b = _export(pkg, tmp_path / pkg / "base", t0, d0, step=3)
        dirs[pkg] = _delta(pkg, tmp_path / pkg / "d1", b, t1, d1, step=4, **kw)
    assert_same_bundle(tmp_path / "jax" / "base", tmp_path / "port" / "base")
    assert_same_bundle(dirs["jax"], dirs["port"])
    m = json.loads((dirs["port"] / "bundle.json").read_text())
    assert m["kind"] == "delta" and m["version"] == 1 and m["tables_delta"]
    assert m["replaced"]
    # composed onto its base: the full export of the new state, bitwise
    full = _export("port", tmp_path / "full1", t1, d1, step=4, version=1)
    fm, fa = texp.read_raw_bundle(full)
    cm, ca = texp.apply_delta_arrays(*texp.read_raw_bundle(tmp_path / "port" / "base"),
                                     *texp.read_raw_bundle(dirs["port"]))
    jm, ja = jexp.apply_delta_arrays(*jexp.read_raw_bundle(tmp_path / "jax" / "base"),
                                     *jexp.read_raw_bundle(dirs["jax"]))
    assert cm == fm == jm
    assert sorted(ca) == sorted(fa) == sorted(ja)
    for k in fa:
        assert ca[k].tobytes() == fa[k].tobytes() == ja[k].tobytes(), k


def _refusal(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 (the refusal is the result)
        return type(e).__name__, str(e)
    return None


def test_chain_refusals_are_the_reference_refusals(tmp_path):
    _, t0, d0 = _base()
    t1, d1 = _bumped(t0, d0, seed=1)
    t2, d2 = _bumped(t1, d1, seed=2)
    o1, od1 = _bumped(t0, d0, seed=9)
    stale = {n: v[1:] for n, v in _changed_rows(t1).items()}
    got = {}
    for pkg, exp in (("jax", jexp), ("port", texp)):
        r = tmp_path / pkg
        full0 = _export(pkg, r / "v0", t0, d0, step=0)
        delta1 = _delta(pkg, r / "d1", full0, t1, d1, step=1)
        full1 = _export(pkg, r / "v1", t1, d1, step=1, version=1)
        delta2 = _delta(pkg, r / "d2", full1, t2, d2, step=2)
        other1 = _export(pkg, r / "o1", o1, od1, step=1, version=1)
        b0, b1 = exp.read_raw_bundle(full0), exp.read_raw_bundle(full1)
        dl1, dl2 = exp.read_raw_bundle(delta1), exp.read_raw_bundle(delta2)
        torn = dict(dl1[1])
        k = sorted(torn)[0]
        torn[k] = np.array(torn[k])
        torn[k].view(np.uint8).reshape(-1)[0] ^= 0xFF
        promise = dict(dl1[0], result_digest="0" * 16)
        promise["digest"] = exp.bundle_digest(promise, dl1[1])
        got[pkg] = {
            "gap": _refusal(lambda: exp.apply_delta_arrays(*b0, *dl2)),
            "reorder": _refusal(lambda: exp.apply_delta_arrays(*b1, *dl1)),
            "parent": _refusal(lambda: exp.apply_delta_arrays(
                *exp.read_raw_bundle(other1), *dl2)),
            "payload": _refusal(lambda: exp.apply_delta_arrays(*b0, dl1[0], torn)),
            "result": _refusal(lambda: exp.apply_delta_arrays(*b0, promise, dl1[1])),
            "not_delta": _refusal(lambda: exp.apply_delta_arrays(*b0, *b1)),
            "stale_hint": _refusal(lambda: _delta(pkg, r / "s", full0, t1, d1,
                                                  step=1, touched=stale)),
            "drift": _refusal(lambda: _delta(pkg, r / "x", full0, t1, d1, step=1,
                                             cont_columns=("avg_rating",))),
        }
    for case, want in got["jax"].items():
        assert want is not None, case
        assert got["port"][case] == want, case
    assert "out of order" in got["port"]["gap"][1]
    assert "parent digest" in got["port"]["parent"][1]
    assert "outside the touched-row hint" in got["port"]["stale_hint"][1]
    assert "schema drift" in got["port"]["drift"][1]


def _tree(root: Path) -> dict:
    """Every file under a store: bytes, with the records' clock fields and
    the quarantine paths (which name each test's directory) dropped."""
    out = {}
    for p in sorted(root.rglob("*")):
        if not p.is_file():
            continue
        rel = str(p.relative_to(root))
        if p.name in ("rejections.json", "quarantine.json"):
            out[rel] = [{k: v for k, v in r.items() if k not in ("time", "path")}
                        for r in json.loads(p.read_text())]
        else:
            out[rel] = p.read_bytes()
    return out


def _store_ops(swap, root, d, log):
    """The operation sequence, run on one package's store; ``log`` gets
    each operation's result (or its refusal) and the tree after it."""
    store = swap.BundleStore(root)

    def step(name, fn):
        res = _refusal(fn) or ("ok",)
        if res == ("ok",):
            res = ("ok", fn.__dict__.get("value"))
        log.append((name, res, _tree(root)))

    def op(f):
        def g():
            g.value = f()
        return g

    step("ingest", op(lambda: store.ingest_full(d["v0"])))
    step("apply", op(lambda: store.apply_delta(d["d1"])))
    step("reapply", op(lambda: store.apply_delta(d["d1"])))
    step("canary", op(lambda: store.publish_canary(d["d2"])))
    step("rollback", op(lambda: store.rollback_canary("auc regressed")))
    step("canary_again", op(lambda: store.publish_canary(d["d2b"])))
    step("promote", op(lambda: store.promote_canary()))
    # crash points, each followed by recover()
    (root / "versions" / "v000003.tmp").mkdir()
    (root / "versions" / "v000003.tmp" / "arrays.npz").write_bytes(b"torn")
    step("recover_stray_tmp", op(lambda: store.recover()))
    swap.atomic_write_json(root / "CANARY", {"version": 3, "digest": "f" * 16})
    step("recover_pointer_only_canary", op(lambda: store.recover()))
    v2 = root / "versions" / "v000002" / "arrays.npz"
    v2.write_bytes(v2.read_bytes()[:-64])  # torn newest version
    step("recover_torn_head", op(lambda: store.recover()))
    step("quarantine", op(lambda: store.record_quarantine(d["d2"], "corrupt")))
    step("gc", op(lambda: swap.BundleStore(root, keep_versions=1).gc_versions()))


def test_store_operations_leave_the_reference_bytes(tmp_path):
    _, t0, d0 = _base()
    t1, d1 = _bumped(t0, d0, seed=1)
    t2, d2 = _bumped(t1, d1, seed=2)
    t2b, d2b = _bumped(t1, d1, seed=3)
    src = tmp_path / "src"
    d = {"v0": _export("port", src / "v0", t0, d0, step=0)}
    d["d1"] = _delta("port", src / "d1", d["v0"], t1, d1, step=1)
    v1 = _export("port", src / "v1", t1, d1, step=1, version=1)
    d["d2"] = _delta("port", src / "d2", v1, t2, d2, step=2)
    d["d2b"] = _delta("port", src / "d2b", v1, t2b, d2b, step=2)
    logs = {}
    for pkg, swap in (("jax", jswap), ("port", tswap)):
        logs[pkg] = []
        _store_ops(swap, tmp_path / pkg, d, logs[pkg])
    for (name, jres, jtree), (_, tres, ttree) in zip(logs["jax"], logs["port"]):
        assert tres == jres, name
        assert ttree == jtree, name
    final = dict((n, r) for n, r, _ in logs["port"])
    assert final["apply"] == ("ok", 1) and final["promote"] == ("ok", 2)
    assert final["reapply"][0] == "DeltaChainError"
    assert final["recover_torn_head"] == ("ok", 1)


def test_swap_controller_quarantines_then_recovers_as_the_reference(tmp_path):
    _, t0, d0 = _base()
    t1, d1 = _bumped(t0, d0, seed=1)
    src = tmp_path / "src"
    v0 = _export("port", src / "v0", t0, d0, step=0)
    chain = src / "chain"
    _delta("port", chain / "v000001", v0, t1, d1, step=1)
    out = {}
    for pkg, swap, fmod in (("jax", jswap, jfaults), ("port", tswap, tfaults)):
        store = swap.BundleStore(tmp_path / pkg)
        store.ingest_full(v0)
        built = []
        ctl = swap.SwapController(store, lambda p, b=built: b.append(p.name) or p,
                                  max_bad_deltas=1)
        poller = swap.DeltaPoller(chain, poll_s=0.0)
        fmod.configure(fmod.FaultSpec(corrupt_delta_nth=1))
        first = ctl.poll(poller)  # corrupted at its read: quarantined
        degraded = ctl.degraded
        fmod.configure(None)
        second = ctl.poll(poller)  # the bytes on disk verify: re-applied
        out[pkg] = (first, degraded, second, ctl.degraded, store.current_version(),
                    built, [q["error"][:40] for q in store.quarantined()])
    assert out["port"] == out["jax"] == (False, True, True, False, 1,
                                         ["v000001"], out["jax"][6])


_KILL_CHILD = """
import json, sys
from pathlib import Path
from tdfo_tpu_torch.serve.swap import BundleStore
from tdfo_tpu_torch.utils.faults import FaultSpec, configure
root = Path(sys.argv[1])
configure(FaultSpec(kill_during_swap=1), workdir=root)
store = BundleStore(root / "store")
recovered = store.recover()
if store.current_version() is None:
    store.ingest_full(root / "v0")
version = store.apply_delta(root / "d1")  # the first run dies in here
print(json.dumps({"recovered": recovered, "version": version}))
"""


def test_kill_during_swap_in_a_child_then_recover(tmp_path):
    _, t0, d0 = _base()
    t1, d1 = _bumped(t0, d0, seed=1)
    v0 = _export("port", tmp_path / "v0", t0, d0, step=0)
    _delta("port", tmp_path / "d1", v0, t1, d1, step=1)
    repo = str(Path(__file__).resolve().parents[1])
    env = {"PYTHONPATH": repo, "PATH": "/usr/bin:/bin"}
    run = [sys.executable, "-c", _KILL_CHILD, str(tmp_path)]
    first = subprocess.run(run, capture_output=True, text=True, env=env, timeout=120)
    assert first.returncode == tfaults.KILL_EXIT_CODE, first.stderr
    store = tmp_path / "store"
    assert (store / "versions" / "v000001.tmp").is_dir()  # staged, unpublished
    assert not (store / "versions" / "v000001").exists()
    assert json.loads((store / "CURRENT").read_text())["version"] == 0
    second = subprocess.run(run, capture_output=True, text=True, env=env, timeout=120)
    assert second.returncode == 0, second.stderr
    assert json.loads(second.stdout.strip().splitlines()[-1]) == {"recovered": 0,
                                                                 "version": 1}
    # the reference store, applying the same delta with no crash
    ref = jswap.BundleStore(tmp_path / "ref")
    ref.ingest_full(v0)
    ref.apply_delta(tmp_path / "d1")
    assert _tree(store) == _tree(tmp_path / "ref")
    shutil.rmtree(tmp_path / "ref")


@pytest.mark.parametrize("source", ["cache", "batches"])
def test_touched_hint_from_the_cache_or_the_batches(tmp_path, source):
    """``touched_rows`` from an unflushed update cache's dirty rows, or
    from the ids of the batches trained since the base, covers every row
    the port's sparse step changed: ``export_delta`` accepts it, and the
    composed bundle is the full export; a hint of the first step alone is
    stale and refused."""
    from torch_serve_helpers import SIZE_MAP, ctr_batch

    from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.parallel.embedding import CACHE_PREFIX, ShardedEmbeddingCollection
    from tdfo_tpu_torch.train.ctr import ctr_sparse_forward
    from tdfo_tpu_torch.train.sparse_step import SparseTrainState, make_sparse_train_step

    coll = ShardedEmbeddingCollection(ctr_embedding_specs(SIZE_MAP, 16, "row"),
                                      cache_rows=256 if source == "cache" else 0)
    bb = TwoTowerBackbone(16, generator=torch.Generator().manual_seed(2))
    opt = sparse_optimizer("adagrad", lr=0.05)
    state = SparseTrainState.create(backbone=bb, tables=coll.init(4, device="cpu"),
                                    sparse_opt=opt, learning_rate=1e-3,
                                    weight_decay=0.0)
    state.slots.update(coll.init_caches(state.tables, opt))
    step = make_sparse_train_step(coll, ctr_sparse_forward(bb))
    caches = lambda: {k: v for k, v in state.slots.items()  # noqa: E731
                      if k.startswith(CACHE_PREFIX)}
    kw = lambda: dict(coll=coll, tables=state.tables, dense_params=bb,  # noqa: E731
                      caches=caches() or None, **twotower_export_kw())
    base = texp.export_bundle(tmp_path / "base", step=0, **kw())
    rng = np.random.default_rng(11)
    batches = []
    for i in range(2):
        b = ctr_batch(rng, 24)
        b["label"] = rng.integers(0, 2, 24).astype(np.float32)
        batches.append({c: b[c] for c in b if c != "label"})
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        if i == 0:
            first = (texp.touched_rows(coll, caches=caches()) if source == "cache"
                     else texp.touched_rows(coll, batches=batches[:1]))
    hint = (texp.touched_rows(coll, caches=caches()) if source == "cache"
            else texp.touched_rows(coll, batches=batches))
    assert sum(v.size for v in hint.values()) > 0
    with pytest.raises(ValueError, match="outside the touched-row hint"):
        texp.export_delta(tmp_path / "stale", base, step=2, touched=first, **kw())
    delta = texp.export_delta(tmp_path / "d", base, step=2, touched=hint, **kw())
    full = texp.export_bundle(tmp_path / "full", step=2, version=1, **kw())
    cm, ca = texp.apply_delta_arrays(*texp.read_raw_bundle(base),
                                     *texp.read_raw_bundle(delta))
    fm, fa = texp.read_raw_bundle(full)
    assert cm == fm and all(ca[k].tobytes() == fa[k].tobytes() for k in fa)
