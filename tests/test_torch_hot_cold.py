"""Hot/cold (frequency-partitioned) tables of the PyTorch port against
``tdfo_tpu``, and int8 + update cache + hot/cold composed in the sparse
step and the trainer.

Held exactly: the route split of both forms (a ``[0, K)`` prefix by one
compare, any other set by ``torch.searchsorted``) and of a fully hot
table, ``hot_ids_from_counts``, the digests, the ``hot_ids.json`` the CTR
ETL writes (the Criteo ETL's: ``test_torch_criteo_data.py``), the hot
heads at init (a gather of the cold rows, decoded for int8) and the
lookup.  Held to the trajectory rung (rtol 1e-4): three steps of the
DLRM step with int8 storage, the update cache and hot heads against the
reference's (the head's segment sum runs in another order than the
reference's one-hot contraction).  On the CPU, bitwise: a trainer run
killed after a save inside a flush interval resumes to the uninterrupted
run's state, and the restore refuses an edited hot set or another int8
sidecar storage, in the reference's words."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tdfo_tpu.data import hot_ids as jhot
from tdfo_tpu.models.dlrm import DLRMBackbone as JDLRM
from tdfo_tpu.models.dlrm import generic_embedding_specs as j_specs
from tdfo_tpu.ops.sparse import sparse_optimizer as j_opt
from tdfo_tpu.parallel.embedding import ShardedEmbeddingCollection as JColl
from tdfo_tpu.train.ctr import ctr_sparse_forward as j_fwd
from tdfo_tpu.train.sparse_step import SparseTrainState as JState
from tdfo_tpu.train.sparse_step import make_cache_flush_fn as j_flush_fn
from tdfo_tpu.train.sparse_step import make_sparse_train_step as j_step
from tdfo_tpu_torch.core.config import read_configs
from tdfo_tpu_torch.data import hot_ids as thot
from tdfo_tpu_torch.interop import TOL, backbone_params_from_flax, tables_from_numpy
from tdfo_tpu_torch.models.dlrm import DLRMBackbone as TDLRM
from tdfo_tpu_torch.models.dlrm import generic_embedding_specs as t_specs
from tdfo_tpu_torch.ops.quant import dequantize_rows
from tdfo_tpu_torch.ops.sparse import sparse_optimizer as t_opt
from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection as TColl
from tdfo_tpu_torch.parallel.embedding import qscale_name
from tdfo_tpu_torch.train.ctr import ctr_sparse_forward as t_fwd
from tdfo_tpu_torch.train.sparse_step import SparseTrainState as TState
from tdfo_tpu_torch.train.sparse_step import make_cache_flush_fn as t_flush_fn
from tdfo_tpu_torch.train.sparse_step import make_sparse_train_step as t_step
from tdfo_tpu_torch.train.trainer import Trainer

SIZES = {"c0": 400, "c1": 90, "c2": 12, "c3": 300}
CATS, CONTS, DIM, B, LR = tuple(SIZES), ("x0", "x1"), 8, 64, 3e-4
# c0: a [0, K) prefix; c1: a scattered set; c2: fully hot; c3: cold only
HOT = {"c0": np.arange(32, dtype=np.int32),
       "c1": np.array([1, 4, 5, 17, 40, 41, 88], np.int32),
       "c2": np.arange(12, dtype=np.int32)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the steps are tiny, and the suite runs several
    test processes at once (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(make, dtype, **kw):
    return [dataclasses.replace(s, dtype=dtype)
            for s in make(SIZES, CATS, DIM, "row", fused_threshold=None, **kw)]


def _batch(rng):
    out = {c: rng.integers(0, v, B).astype(np.int32) for c, v in SIZES.items()}
    out["c0"][: B // 2] = rng.integers(0, 40, B // 2)  # mostly hot
    out["c1"][::4] = 5
    out.update({c: rng.random(B, dtype=np.float32) for c in CONTS})
    out["label"] = rng.integers(0, 2, B).astype(np.float32)
    return out


def test_route_split_matches_jax():
    rng = np.random.default_rng(0)
    jc = JColl(_specs(j_specs, jnp.float32), hot_ids=HOT)
    tc = TColl(_specs(t_specs, torch.float32), hot_ids=HOT)
    ids = {c: rng.integers(-2, v, (5, 7)).astype(np.int32) for c, v in SIZES.items()}
    want = jax.jit(lambda i: {c: jc.route_ids(c, i[c]) for c in CATS})(ids)
    for c in CATS:
        hp, cold = tc.route_ids(c, torch.from_numpy(ids[c]))
        if c == "c3":
            assert hp is None and want[c][0] is None
            continue
        np.testing.assert_array_equal(hp.numpy(), np.asarray(want[c][0]), err_msg=c)
        np.testing.assert_array_equal(cold.numpy(), np.asarray(want[c][1]), err_msg=c)
    assert tc._hot_prefix == {"c0_embed": True, "c1_embed": False, "c2_embed": True}
    assert tc.hot_full("c2_embed") and not tc.hot_full("c0_embed")
    assert tc.hot_tables() == jc.hot_tables() and tc.hot_count("c1_embed") == 7
    assert tc.hot_digest() == jc.hot_digest()
    with pytest.raises(ValueError, match="sorted unique"):
        TColl(_specs(t_specs, torch.float32), hot_ids={"c1": np.array([3, 2])})


def test_hot_ids_from_counts_digest_and_artifact(tmp_path):
    rng = np.random.default_rng(1)
    counts = {"a": rng.zipf(1.3, 500) % 97, "b": np.zeros(50, np.int64),
              "c": rng.integers(0, 5, 8)}
    for name, c in counts.items():
        for hv, hf in ((16, 0.9), (200, 0.5), (4, 1.0)):
            np.testing.assert_array_equal(
                thot.hot_ids_from_counts(c, hot_vocab=hv, hot_fraction=hf),
                jhot.hot_ids_from_counts(c, hot_vocab=hv, hot_fraction=hf))
    per = {k: thot.hot_ids_from_counts(c, hot_vocab=16) for k, c in counts.items()}
    assert thot.hot_ids_digest(per) == jhot.hot_ids_digest(per)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    thot.write_hot_ids(tmp_path / "t", per, hot_vocab=16, hot_fraction=0.9)
    jhot.write_hot_ids(tmp_path / "j", per, hot_vocab=16, hot_fraction=0.9)
    assert ((tmp_path / "t" / "hot_ids.json").read_bytes()
            == (tmp_path / "j" / "hot_ids.json").read_bytes())
    back = thot.load_hot_ids(tmp_path / "t")
    assert all(np.array_equal(back[k], per[k]) for k in per)
    assert thot.load_hot_ids(tmp_path) is None


def test_ctr_etl_writes_the_reference_hot_ids(tmp_path):
    """``preprocess-ctr`` with ``hot_vocab > 0``: the same ``hot_ids.json``
    byte for byte (user and item, scattered sets from train counts)."""
    from tdfo_tpu.data import ctr_preprocessing as jprep
    from tdfo_tpu.data import synthetic as jsyn
    from tdfo_tpu_torch.data import ctr_preprocessing as tprep

    for d in ("j", "t"):
        jsyn.write_synthetic_goodreads(tmp_path / d, n_users=40, n_books=60)
    jprep.run_ctr_preprocessing(tmp_path / "j", file_num=2, hot_vocab=8,
                                hot_fraction=0.5)
    tprep.run_ctr_preprocessing(tmp_path / "t", file_num=2, hot_vocab=8,
                                hot_fraction=0.5)
    got = (tmp_path / "t" / "hot_ids.json").read_bytes()
    assert got == (tmp_path / "j" / "hot_ids.json").read_bytes()
    assert set(json.loads(got)["tables"]) == {"user_id", "item_id"}


def test_hot_heads_at_init_and_lookup():
    """The port's init: each head is its cold rows gathered (int8: decoded
    on the parent's grid), under the reference's array names; the lookup
    through int8 tables and heads equals the reference's on the same
    arrays."""
    tc = TColl(_specs(t_specs, torch.int8), hot_ids=HOT, stack_tables=True)
    tables = tc.init(3, device="cpu")
    for t in tc.hot_tables():
        aname, _, off = tc.resolve_table(t)
        idx = torch.from_numpy(tc.hot_ids[t].astype(np.int64) + off)
        want = dequantize_rows(tables[aname][idx], tables[qscale_name(aname)][idx])
        assert torch.equal(tables[tc.hot_array_name(t)], want)
    jc = JColl(_specs(j_specs, jnp.int8), hot_ids=HOT, stack_tables=True)
    assert sorted(jax.eval_shape(jc.init, jax.random.key(0))) == sorted(tables)
    rng = np.random.default_rng(4)
    ids = {c: rng.integers(-1, v, (6, 3)).astype(np.int32) for c, v in SIZES.items()}
    want = jax.jit(lambda t, i: jc.lookup(t, i))(
        {k: v.numpy() for k, v in tables.items()}, ids)
    got = tc.lookup(tables, {c: torch.from_numpy(v) for c, v in ids.items()})
    for c in CATS:
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]), err_msg=c)


def _flax_params(backbone):
    """The flax param tree of a port ``DLRMBackbone`` (``Linear.weight
    [out, in]`` -> ``Dense.kernel [in, out]``): the inverse of
    ``interop.backbone_params_from_flax``."""
    tree = {}
    for name, v in backbone.state_dict().items():
        mod, leaf = name.rsplit(".", 1)
        v = v.numpy()
        tree.setdefault(mod, {})["kernel" if leaf == "weight" else leaf] = (
            v.T if leaf == "weight" else v)
    return jax.tree.map(jnp.asarray, tree)


def _jax_side():
    """The reference's collection and state over the port's initial int8
    tables, sidecars and heads and a port backbone's params (the arrays
    carry over as they are)."""
    jc = JColl(_specs(j_specs, jnp.int8), hot_ids=HOT, stack_tables=True,
               fused_kind="adam", cache_rows=256)
    tc = TColl(_specs(t_specs, torch.int8), hot_ids=HOT, stack_tables=True,
               fused_kind="adam", cache_rows=256)
    jtables = {k: jnp.asarray(v.numpy()) for k, v in tc.init(0, device="cpu").items()}
    jb = JDLRM(embed_dim=DIM, cat_columns=CATS, cont_columns=CONTS)
    dense = _flax_params(TDLRM(DIM, cat_columns=CATS, cont_columns=CONTS,
                               generator=torch.Generator().manual_seed(1)))
    opt = j_opt("adam", lr=LR, small_vocab_threshold=0)
    state = JState.create(dense_params=dense, tx=optax.adamw(LR, weight_decay=1e-4),
                          tables=jtables, sparse_opt=opt)
    caches = jc.init_caches(state.tables, opt)
    state = dataclasses.replace(state, slots={**state.slots, **caches})
    return jc, jb, state


def test_int8_cache_hot_trajectory_matches_jax():
    """Three DLRM steps (``dedup_lookup``) over int8 plain stacks with the
    update cache (a flush after step 2) and hot heads (prefix, scattered and
    fully hot), from the same tables and params: losses, decoded
    tables, heads and slots at the trajectory rung; the cached arrays and
    the flush counts as in the reference."""
    rng = np.random.default_rng(5)
    batches = [_batch(rng) for _ in range(3)]
    jc, jb, jstate = _jax_side()
    jrun = j_step(jc, j_fwd(jb), donate=False, dedup_lookup=True)
    jflush = j_flush_fn(donate=False)
    tc = TColl(_specs(t_specs, torch.int8), hot_ids=HOT, stack_tables=True,
               fused_kind="adam", cache_rows=256)
    tb = TDLRM(DIM, cat_columns=CATS, cont_columns=CONTS)
    tb.load_state_dict(backbone_params_from_flax(
        jax.tree.map(np.asarray, jstate.dense_params)))
    opt = t_opt("adam", lr=LR, small_vocab_threshold=0)
    tstate = TState.create(
        backbone=tb, tables=tables_from_numpy(
            {k: np.asarray(v) for k, v in jstate.tables.items()}),
        sparse_opt=opt, learning_rate=LR, weight_decay=1e-4)
    caches = tc.init_caches(tstate.tables, opt)
    assert sorted(caches) == sorted(k for k in jstate.slots if k.startswith("__cache__/"))
    tstate.slots.update(caches)
    trun, tflush = t_step(tc, t_fwd(tb), dedup_lookup=True), t_flush_fn()
    jl, tl = [], []
    for i, b in enumerate(batches):
        jstate, loss = jrun(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jl.append(float(loss))
        tstate, loss = trun(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        tl.append(float(loss))
        if i == 1:
            jstate, jover = jflush(jstate)
            tstate, tover = tflush(tstate)
            assert {k: int(v) for k, v in tover.items()} == {
                k: int(v) for k, v in jover.items()} == dict.fromkeys(jover, 0)
    jstate, _ = jflush(jstate)
    tstate, _ = tflush(tstate)
    rtol, atol = TOL["trajectory"]
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=atol)
    for name, jt in jstate.tables.items():
        if name.startswith("__qscale__/"):
            continue
        got, want = tstate.tables[name], np.asarray(jt)
        if got.dtype == torch.int8:  # compare the decoded rows
            q = qscale_name(name)
            got = dequantize_rows(got, tstate.tables[q])
            want = dequantize_rows(want, np.asarray(jstate.tables[q]))
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol,
                                   err_msg=name)
        for a, b in zip(tstate.slots[name], jstate.slots[name]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                       atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def criteo(tmp_path_factory):
    from tdfo_tpu_torch.data.criteo_preprocessing import run_criteo_preprocessing
    from tdfo_tpu_torch.data.synthetic import write_synthetic_criteo

    root = tmp_path_factory.mktemp("criteo_hot")
    write_synthetic_criteo(root, n_rows=2000, seed=2)
    size_map = run_criteo_preprocessing(root, hot_vocab=24, hot_fraction=0.6,
                                        file_num=2)
    return root, size_map


def _cfg(criteo, ckpt, **emb):
    from tdfo_tpu_torch.data.criteo_preprocessing import (
        CRITEO_CATEGORICAL,
        CRITEO_CONTINUOUS,
    )

    d, size_map = criteo
    embeddings = dict(table_dtype="int8", cache_rows=2048, flush_every=2,
                      hot_vocab=24)
    embeddings.update(emb)
    return read_configs(
        None, data_dir=str(d), model="dlrm", n_epochs=1, embed_dim=8,
        learning_rate=3e-3, per_device_train_batch_size=128,
        per_device_eval_batch_size=256, shuffle_buffer_size=300,
        log_every_n_steps=2, checkpoint_dir=str(ckpt),
        checkpoint_every_n_steps=3, size_map=size_map, seed=7,
        categorical_features=list(CRITEO_CATEGORICAL),
        continuous_features=list(CRITEO_CONTINUOUS), stack_tables=True,
        dedup_lookup=True, sparse_optimizer="adagrad",
        fused_table_threshold=-1, embeddings=embeddings)


class _Killed(Exception):
    pass


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return _leaves(dict(enumerate(tree)), prefix)
    return {prefix: tree}


def test_resume_inside_a_flush_interval_is_bitwise(criteo, tmp_path):
    """int8 + update cache (flush every 2 steps) + hot heads: a run killed
    before step 6 resumes from its step-3 save, which falls inside a flush
    interval, and ends bit for bit where the uninterrupted run ends; then
    the restore refuses an edited ``hot_ids.json`` and a run whose int8
    sidecars would live elsewhere (fused lines), in the reference's
    words."""
    tr = Trainer(_cfg(criteo, tmp_path / "ck"), log_dir=tmp_path / "l1", device="cpu")
    assert tr.coll.hot_tables() and tr._flush_every == 2
    assert any(k.startswith("__cache__/") for k in tr.state.slots)
    assert {t.dtype for k, t in tr.state.tables.items()
            if k.startswith("__tablestack_")} == {torch.int8}
    inner, calls = tr.train_step, [0]

    def dying(*args):
        calls[0] += 1
        if calls[0] == 6:
            raise _Killed
        return inner(*args)

    tr.train_step = dying
    with pytest.raises(_Killed):
        tr.fit()
    stamps = json.loads((tmp_path / "ck" / "stamps_3.json").read_text())
    assert set(stamps) == {"hot_ids", "table_dtype", "slot_dtype",
                           "qscale_layout", "update_cache"}
    tr2 = Trainer(_cfg(criteo, tmp_path / "ck"), log_dir=tmp_path / "l2", device="cpu")
    m2 = tr2.fit()
    tr3 = Trainer(_cfg(criteo, tmp_path / "ref"), log_dir=tmp_path / "l3", device="cpu")
    m3 = tr3.fit()
    assert m2 == m3
    a, b = _leaves(tr2.state.state_dict()), _leaves(tr3.state.state_dict())
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    # an edited hot set refuses, in the reference's words
    path = criteo[0] / "hot_ids.json"
    orig = path.read_text()
    art = json.loads(orig)
    art["tables"]["cat_3"] = art["tables"]["cat_3"][:-1]
    path.write_text(json.dumps(art))
    try:
        with pytest.raises(ValueError, match="different hot-id set"):
            Trainer(_cfg(criteo, tmp_path / "ck"), log_dir=tmp_path / "l5",
                    device="cpu").fit()
    finally:
        path.write_text(orig)


def test_int8_sidecar_storage_is_stamped(criteo, tmp_path):
    """Fused int8 lines carry their sidecar in-line: the stamps name that
    storage (``qscale_storage``), so a checkpoint of plain int8 arrays
    refuses to restore into a fused int8 run (and the reverse); the
    reference's refusals of the combinations it does not build hold."""
    plain = Trainer(_cfg(criteo, tmp_path / "a", hot_vocab=0, cache_rows=0),
                    log_dir=tmp_path / "la", device="cpu")
    fused = Trainer(dataclasses.replace(
        _cfg(criteo, tmp_path / "b", hot_vocab=0, cache_rows=0),
        fused_table_threshold=20), log_dir=tmp_path / "lb", device="cpu")
    sa, sb = plain._ckpt_stamps, fused._ckpt_stamps
    assert "qscale_storage" not in sa and set(sb) == set(sa) | {"qscale_storage"}
    assert sb["qscale_layout"] == "rowwise-f32-scale-offset-v1"
    assert any(k.startswith("__fatstack_") and v.dtype == torch.int8
               for k, v in fused.state.tables.items())
    plain._save(1, {"epoch": 0, "step": 1, "epoch_complete": False,
                    "global_step": 1})
    with pytest.raises(ValueError, match="WRONG ids"):
        plain._ckpt.restore(fused.state, stamps=sb)
    with pytest.raises(ValueError, match="rowwise_adagrad"):
        Trainer(dataclasses.replace(
            _cfg(criteo, tmp_path / "c", hot_vocab=0, cache_rows=0),
            fused_table_threshold=20, sparse_optimizer="rowwise_adagrad"),
            log_dir=tmp_path / "lc", device="cpu")


def test_trainer_refuses_cache_overflow(criteo, tmp_path):
    """A cache too small for one flush interval fails the run loudly, in
    the reference's words, at the first check."""
    cfg = _cfg(criteo, tmp_path / "ck", cache_rows=16, hot_vocab=0)
    with pytest.raises(RuntimeError, match="update-cache admission overflow"):
        Trainer(cfg, log_dir=tmp_path / "l", device="cpu").fit()
