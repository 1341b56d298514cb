"""CTR scoring of the PyTorch port against ``tdfo_tpu``'s, on the CPU.

Each package scores the other's bundle: a bundle the JAX package writes
scores in the port, and the port's bundle scores in the JAX package, with
logits at the ladder's forward rung (``interop.TOL["logits"]``), for the
DMP TwoTower (fat stack), DLRM and the dense-regime TwoTower.  The served
logits equal the port's own eval step's on the same rows (at the same
rung); the towers factorize the score; the scorer counts the batch shapes
it has run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_serve_helpers import (
    CAT_COLS,
    CONT_COLS,
    SIZE_MAP,
    StubMesh,
    ctr_batch,
    jax_twotower,
    np_of,
    port_twotower,
    twotower_export_kw,
)

from tdfo_tpu.serve.export import export_bundle as j_export
from tdfo_tpu.serve.export import load_bundle as j_load
from tdfo_tpu.serve.scoring import make_scorer as j_scorer
from tdfo_tpu_torch.interop import TOL
from tdfo_tpu_torch.serve.export import export_bundle as t_export
from tdfo_tpu_torch.serve.export import load_bundle as t_load
from tdfo_tpu_torch.serve.scoring import make_scorer as t_scorer

RTOL, ATOL = TOL["logits"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twotower(tmp_path_factory):
    """The JAX state, its port carry, and both packages' bundles of it."""
    tmp = tmp_path_factory.mktemp("tt")
    jc, jb, jt, jd = jax_twotower(fused_threshold=200, seed=5)
    tc, tt, tb = port_twotower(jt, jd, fused_threshold=200)
    jdir = j_export(tmp / "jax", coll=jc, tables=jt, dense_params=jd,
                    **twotower_export_kw())
    tdir = t_export(tmp / "torch", coll=tc, tables=tt, dense_params=tb,
                    **twotower_export_kw())
    return dict(jc=jc, jb=jb, jt=jt, jd=jd, tc=tc, tt=tt, tb=tb,
                jdir=jdir, tdir=tdir)


def _cross_check(jdir, tdir, batch, towers=True):
    """Port scorer on the JAX bundle vs the JAX scorer on the port bundle
    (and each on its own)."""
    tsc = t_scorer(t_load(jdir), device="cpu")
    jsc = j_scorer(j_load(tdir))
    nolabel = {k: v for k, v in batch.items() if k != "label"}
    want = np.asarray(jsc.score(dict(nolabel)))
    got = tsc.score(nolabel)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if towers:
        for name in ("user_embed", "item_embed"):
            np.testing.assert_allclose(
                getattr(tsc, name)(nolabel).numpy(),
                np.asarray(getattr(jsc, name)(dict(nolabel))),
                rtol=RTOL, atol=ATOL, err_msg=name)
    return tsc, got


def test_dmp_twotower_bundles_score_across_packages(twotower):
    batch = ctr_batch(np.random.default_rng(7), 48)
    tsc, got = _cross_check(twotower["jdir"], twotower["tdir"], batch)
    # the served logits are the port's eval step's on the live state
    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.train.ctr import make_ctr_sparse_eval_step
    from tdfo_tpu_torch.train.sparse_step import SparseTrainState

    state = SparseTrainState.create(backbone=twotower["tb"], tables=twotower["tt"],
                                    sparse_opt=sparse_optimizer("adam", lr=1e-3),
                                    learning_rate=1e-3, weight_decay=0.0)
    batch["label"] = np.zeros(48, np.float32)
    _, ref = make_ctr_sparse_eval_step(twotower["tc"], twotower["tb"])(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)
    # the towers factorize the score (what makes retrieval score-consistent)
    u, it = tsc.user_embed(batch), tsc.item_embed(batch)
    np.testing.assert_allclose((u * it).sum(-1).numpy(), got.numpy(), atol=1e-5)


def test_scorer_counts_batch_shapes(twotower):
    sc = t_scorer(t_load(twotower["tdir"]), device="cpu")
    rng = np.random.default_rng(1)
    for n in (8, 16, 8, 8, 16, 32):
        sc.score(ctr_batch(rng, n))
    assert sc.score_cache_size() == 3


def test_dlrm_bundles_score_across_packages(tmp_path):
    from tdfo_tpu.models.dlrm import DLRMBackbone as JDLRM
    from tdfo_tpu.models.dlrm import generic_embedding_specs as jspecs
    from tdfo_tpu.parallel.embedding import ShardedEmbeddingCollection as JColl
    from tdfo_tpu_torch.interop import backbone_params_from_flax, tables_from_numpy
    from tdfo_tpu_torch.models.dlrm import DLRMBackbone as TDLRM
    from tdfo_tpu_torch.models.dlrm import generic_embedding_specs as tspecs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection as TColl

    sizes = {"c0": 7, "c1": 50, "c2": 300}
    cats, conts = tuple(sizes), ("x0",)
    jc = JColl(jspecs(sizes, cats, 8, "row", fused_threshold=None), stack_tables=True)
    tc = TColl(tspecs(sizes, cats, 8, "row", fused_threshold=None), stack_tables=True)
    tt = tc.init(4, device="cpu")
    jt = {k: jnp.asarray(v.numpy()) for k, v in tt.items()}
    jd = jax.jit(JDLRM(embed_dim=8, cat_columns=cats, cont_columns=conts).init)(
        jax.random.key(1), {c: jnp.zeros((1, 8)) for c in cats},
        {c: jnp.zeros((1,)) for c in conts})["params"]
    tb = TDLRM(8, cat_columns=cats, cont_columns=conts)
    tb.load_state_dict(backbone_params_from_flax(jax.tree.map(np.asarray, jd)))
    common = dict(model="dlrm", embed_dim=8, cat_columns=cats, cont_columns=conts,
                  size_map=sizes)
    jdir = j_export(tmp_path / "j", coll=jc, tables=jt, dense_params=jd, **common)
    tdir = t_export(tmp_path / "t", coll=tc, tables=tables_from_numpy(
        {k: v.numpy() for k, v in tt.items()}), dense_params=tb, **common)
    rng = np.random.default_rng(3)
    batch = {c: rng.integers(0, sizes[c], 32).astype(np.int32) for c in cats}
    batch["x0"] = rng.random(32).astype(np.float32)
    tsc, _ = _cross_check(jdir, tdir, batch, towers=False)
    with pytest.raises(ValueError, match="no user tower"):
        tsc.user_embed(batch)


def test_dense_twotower_bundles_score_across_packages(tmp_path):
    from tdfo_tpu.models.twotower import TwoTower as JTwoTower
    from tdfo_tpu_torch.interop import dense_params_from_flax
    from tdfo_tpu_torch.models.twotower import TwoTower as TTwoTower

    sizes = {k: max(4, v // 4) for k, v in SIZE_MAP.items()}
    rng = np.random.default_rng(0)
    batch = ctr_batch(rng, 24, sizes)
    params = jax.jit(JTwoTower(size_map=sizes, embed_dim=8).init)(
        jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    tm = TTwoTower(sizes, 8)
    tm.load_state_dict(dense_params_from_flax(jax.tree.map(np.asarray, params)))
    common = dict(model="twotower", embed_dim=8, cat_columns=CAT_COLS,
                  cont_columns=CONT_COLS, size_map=sizes)
    jdir = j_export(tmp_path / "j", params=params, **common)
    tdir = t_export(tmp_path / "t", params=tm, **common)
    _, got = _cross_check(jdir, tdir, batch)
    with torch.no_grad():
        ref = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)


def test_scorer_refusals(twotower, tmp_path):
    import json

    # under a mesh the parameters replicate: the same scores
    batch = ctr_batch(np.random.default_rng(3), 16)
    assert torch.equal(
        t_scorer(t_load(twotower["tdir"]), mesh=StubMesh(2), device="cpu").score(batch),
        t_scorer(t_load(twotower["tdir"]), device="cpu").score(batch))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_scorer(t_load(twotower["tdir"]))  # the card is the default
    # a bundle whose tables do not cover the model's schema (a 2-table DLRM
    # bundle re-labelled as a 1-column config) is refused, not served
    from tdfo_tpu_torch.models.dlrm import DLRMBackbone, generic_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    sizes = {"c0": 5, "c1": 6}
    coll = ShardedEmbeddingCollection(generic_embedding_specs(
        sizes, ("c0", "c1"), 4, "replicated", fused_threshold=None))
    out = t_export(tmp_path / "d", model="dlrm", embed_dim=4, cat_columns=("c0", "c1"),
                   cont_columns=("x0",), size_map=sizes, coll=coll,
                   tables=coll.init(0, device="cpu"),
                   dense_params=DLRMBackbone(4, cat_columns=("c0", "c1"),
                                             cont_columns=("x0",)))
    m = json.loads((out / "bundle.json").read_text())
    (out / "bundle.json").write_text(json.dumps(dict(m, cat_columns=["c0"])))
    with pytest.raises(ValueError, match="do not match"):
        t_scorer(t_load(out), device="cpu")
    assert np_of(torch.ones(2)).tolist() == [1.0, 1.0]
