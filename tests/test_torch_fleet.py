"""The port's in-process serving fleet (``tdfo_tpu_torch/serve/fleet.py``)
against ``tdfo_tpu/serve/fleet.py`` on the CPU, for a DMP TwoTower (CTR)
and a Bert4Rec (sequence) bundle: both packages' fleets of two replicas
follow one bundle store (its bundles exported by the port, which
``test_torch_serve_export.py`` and ``test_torch_serve_seq.py`` hold
bitwise the reference's) through a pending CANARY and its promotion, and
on the same trace:

* the canary member follows CANARY, the other CURRENT, in both;
* ``probe_each`` is bitwise across the port's replicas once they serve
  one version, and every replica's scores hold rtol 1e-5 of the
  reference replica's (ids of requests exact);
* ``run`` (round-robin) holds the same rule against the reference's;
* the heartbeat records carry the reference's fields, versions, cohorts
  and AUC (``binary_auc`` for CTR, ``ranking_auc`` for sequence panels);
* the skew digest serves the reference's heuristic exactly, the slow
  digest sleeps ``slow_score_ms`` with the scores unchanged, and
  ``kill_replica_nth`` drops the same replica.
"""

import functools

import numpy as np
import pytest
import torch

from torch_serve_helpers import SIZE_MAP, ctr_batch, twotower_export_kw

from tdfo_tpu.core.config import read_configs as j_read_configs
from tdfo_tpu.serve import fleet as jfleet
from tdfo_tpu.utils import faults as jfaults
from tdfo_tpu_torch.core.config import read_configs as t_read_configs
from tdfo_tpu_torch.serve import export as texp
from tdfo_tpu_torch.serve import fleet as tfleet
from tdfo_tpu_torch.serve.swap import BundleStore
from tdfo_tpu_torch.utils import faults as tfaults

SEQ_CFG = dict(n_items=300, max_len=8, embed_dim=16, n_heads=2, n_layers=1)
SERVING = {"replicas": 2, "buckets": [32], "max_batch": 32,
           "batch_deadline_ms": 0.0}


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jfaults.configure(None)
    tfaults.configure(None)


def _bump(tables, backbone, seed):
    """A new state: 6 random rows of every array and the first backbone
    parameter moved."""
    import copy

    rng = np.random.default_rng(seed)
    out = {}
    for k, v in tables.items():
        v = v.clone()
        idx = torch.from_numpy(rng.choice(v.shape[0], min(6, v.shape[0]),
                                          replace=False))
        v[idx] += 0.1 * torch.from_numpy(
            rng.standard_normal(tuple(v[idx].shape)).astype(np.float32))
        out[k] = v
    backbone = copy.deepcopy(backbone)
    with torch.no_grad():
        next(backbone.parameters()).add_(0.05)
    return out, backbone


@functools.lru_cache(maxsize=None)
def _family(kind):
    """(tables, backbone, export kwargs maker, trace maker, model name) of a
    family: the port's seeded init (the bundles are what both fleets read;
    the port's bundles are bitwise the reference's, test_torch_serve_*)."""
    if kind == "ctr":
        from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
        from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

        coll = ShardedEmbeddingCollection(ctr_embedding_specs(
            SIZE_MAP, 16, "row", fused_threshold=200))
        tables = coll.init(5, device="cpu")
        backbone = TwoTowerBackbone(16, generator=torch.Generator().manual_seed(6))

        def export_kw(tables, backbone):
            return dict(coll=coll, tables=tables, dense_params=backbone,
                        **twotower_export_kw())

        def trace(rng, n, tag):
            return [(f"{tag}{i}", ctr_batch(rng, int(rng.integers(1, 30))))
                    for i in range(n)]

        return tables, backbone, export_kw, trace, "twotower"
    from tdfo_tpu_torch.models.bert4rec import Bert4RecConfig, make_sharded_bert4rec
    from tdfo_tpu_torch.serve.seq_scoring import history_window

    coll, tables, backbone = make_sharded_bert4rec(
        Bert4RecConfig(**SEQ_CFG), seed=0, fused_threshold=100, device="cpu")

    def export_kw(tables, backbone):
        return dict(coll=coll, tables=tables, dense_params=backbone,
                    model="bert4rec", embed_dim=16, cat_columns=(), cont_columns=(),
                    size_map={"n_items": 300},
                    seq={"max_len": 8, "n_heads": 2, "n_layers": 1})

    def trace(rng, n, tag):
        out = []
        for i in range(n):
            m = int(rng.integers(1, 12))
            seqs = np.stack([history_window(rng.integers(1, 301, int(rng.integers(1, 14))),
                                            n_items=300, max_len=8) for _ in range(m)])
            out.append((f"{tag}{i}", {"seqs": seqs, "cands": rng.integers(
                1, 301, (m, 21)).astype(np.int32)}))
        return out

    return tables, backbone, export_kw, trace, "bert4rec"


@functools.lru_cache(maxsize=None)
def _fleets(kind, tag):
    """A store holding v0 with the delta v1 pending under CANARY, and both
    packages' fleets following it, synced once (one per ``(kind, tag)``:
    the tests of one tag share it, in file order)."""
    import tempfile
    from pathlib import Path

    tmp = Path(tempfile.mkdtemp(prefix=f"fleet_{kind}_{tag}_"))
    t0, d0, export_kw, trace, model = _family(kind)
    t1, d1 = _bump(t0, d0, seed=1)
    v0 = texp.export_bundle(tmp / "v0", step=0, **export_kw(t0, d0))
    delta = texp.export_delta(tmp / "d1", v0, step=1, **export_kw(t1, d1))
    store = BundleStore(tmp / "store")
    store.ingest_full(v0)
    store.publish_canary(delta)
    kw = dict(model=model, serving=dict(SERVING), size_map={"n_items": 300}
              if model == "bert4rec" else None)
    kw = {k: v for k, v in kw.items() if v is not None}
    if model == "bert4rec":
        kw.update(max_len=8, sliding_step=4, embed_dim=16, n_heads=2, n_layers=1)
    tf = tfleet.ServingFleet(store, t_read_configs(None, **kw), device="cpu")
    jf = jfleet.ServingFleet(store, j_read_configs(None, **kw))
    synced = (tf.sync(), jf.sync())
    return store, tf, jf, trace, synced


def _probe(fleet, reqs):
    """``probe_each`` restricted to ``reqs`` (a batcher's results keep the
    requests it served before)."""
    return {k: {rid: v[rid] for rid, _ in reqs}
            for k, v in fleet.probe_each(reqs).items()}


def _held(got, want):
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        assert (g is None) == (w is None), rid
        if w is not None:
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6,
                                       err_msg=rid)


@pytest.mark.parametrize("kind", ["ctr", "seq"])
def test_fleet_follows_current_and_canary_as_the_reference(kind):
    store, tf, jf, trace, synced = _fleets(kind, "main")
    assert synced[0] == synced[1] == {0: 1, 1: 0}
    reqs = trace(np.random.default_rng(3), 8, "a")
    tp, jp = _probe(tf, reqs), _probe(jf, reqs)
    for k in (0, 1):  # the canary member on v1, the other on v0
        _held(tp[k], jp[k])
    assert any(not np.array_equal(tp[0][r], tp[1][r]) for r in tp[0])
    store.promote_canary()
    assert tf.sync() == jf.sync() == {0: 1, 1: 1}
    reqs = trace(np.random.default_rng(4), 10, "b")
    tp, jp = _probe(tf, reqs), _probe(jf, reqs)
    for rid in tp[0]:
        assert np.array_equal(tp[0][rid], tp[1][rid]), rid  # bitwise
    _held(tp[0], jp[0])
    run = trace(np.random.default_rng(5), 9, "c")
    got, want = tf.run(run), jf.run(run)
    _held({r: got[r] for r, _ in run}, {r: want[r] for r, _ in run})


@pytest.mark.parametrize("kind", ["ctr", "seq"])
def test_heartbeat_records_are_the_reference_records(kind):
    _, tf, jf, trace, _ = _fleets(kind, "main")
    feats = trace(np.random.default_rng(6), 1, "h")[0][1]
    rng = np.random.default_rng(7)
    labels = (None if kind == "seq"
              else rng.integers(0, 2, len(next(iter(feats.values())))).astype(np.float32))
    th, jh = tf.heartbeat(feats, labels), jf.heartbeat(feats, labels)
    assert [sorted(r) for r in th] == [sorted(r) for r in jh]
    for t, j in zip(th, jh):
        for key in ("replica", "version", "canary", "queue_depth"):
            assert t[key] == j[key], key
        assert t["auc"] == pytest.approx(j["auc"], abs=1e-6, nan_ok=True)
        assert t["ms"] > 0


def test_skew_and_slow_digests_and_replica_kill():
    store, tf, jf, trace, _ = _fleets("ctr", "main")
    store.promote_canary()  # both replicas on v1 (a no-op once promoted)
    digest = store._read_pointer("CURRENT")["digest"]
    for f in (tf, jf):
        f.set_score_skew(digest)
    assert tf.sync() == jf.sync() == {0: 1, 1: 1}
    reqs = trace(np.random.default_rng(8), 5, "s")
    tp, jp = _probe(tf, reqs), _probe(jf, reqs)
    for rid, batch in reqs:  # every replica serves the heuristic
        want = -batch["avg_rating"].astype(np.float32)
        for k in (0, 1):
            assert np.array_equal(tp[k][rid], want)
            assert np.array_equal(tp[k][rid], np.asarray(jp[k][rid]))
    assert all(r._served[2] for r in tf.replicas)
    # the slow digest: the same scores, through a slow_score_ms sleep
    tfaults.configure(tfaults.FaultSpec(slow_score_ms=1.0, slow_canary_at_cycle=1))
    tf.set_score_slow(digest)
    tf.sync()
    assert all(r._served[3] for r in tf.replicas)
    again = _probe(tf, reqs)
    for rid in again[1]:
        assert np.array_equal(again[1][rid], tp[1][rid])
    # kill_replica_nth = 2: replica 1 drops dead at the first canary watch
    tfaults.configure(tfaults.FaultSpec(kill_replica_nth=2))
    jfaults.configure(jfaults.FaultSpec(kill_replica_nth=2))
    for f in (tf, jf):
        f.mark_canary_watch()
        f.mark_canary_watch()  # fires once
    assert [r.replica_id for r in tf.alive()] == [r.replica_id for r in jf.alive()] == [0]
