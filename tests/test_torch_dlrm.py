"""DLRMBackbone and the plain-table stacking of the PyTorch port against the
JAX package: a flax DLRM tree carried through ``interop`` with
``strict=True`` gives the same logits (``TOL["logits"]``: rtol 1e-5 /
atol 1e-6) with and without continuous columns; ``generic_embedding_specs``
and the ``stack_tables`` collection (array names, shapes, offsets, lookups
of the reference's tables) equal the reference's exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdfo_tpu.models.dlrm import DLRMBackbone as JBackbone
from tdfo_tpu.models.dlrm import generic_embedding_specs as j_specs
from tdfo_tpu.parallel.embedding import ShardedEmbeddingCollection as JColl
from tdfo_tpu_torch.interop import TOL, backbone_params_from_flax, tables_from_numpy
from tdfo_tpu_torch.models.dlrm import DLRMBackbone as TBackbone
from tdfo_tpu_torch.models.dlrm import generic_embedding_specs as t_specs
from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection as TColl

# a Criteo-shaped schema at tiny vocabs: two tables above the threshold
# (one fat stack), four plain ones (one plain stack with stack_tables)
SIZES = {"c0": 900, "c1": 37, "c2": 5, "c3": 1300, "c4": 120, "c5": 2}
CATS = tuple(SIZES)
CONTS = ("x0", "x1", "x2")


@pytest.mark.parametrize("conts", [CONTS, ()], ids=["cont", "no_cont"])
def test_backbone_logits_match_flax(conts):
    d, b = 8, 32
    rng = np.random.default_rng(len(conts))
    embs = {c: rng.standard_normal((b, d)).astype(np.float32) for c in CATS}
    batch = {c: rng.random(b, dtype=np.float32) for c in conts}
    jb = JBackbone(embed_dim=d, cat_columns=CATS, cont_columns=conts)
    jembs = {k: jnp.asarray(v) for k, v in embs.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jb.init)(jax.random.key(0), jembs, jbatch)["params"]
    want = np.asarray(jax.jit(jb.apply)({"params": params}, jembs, jbatch))
    tb = TBackbone(d, cat_columns=CATS, cont_columns=conts)
    # the carry-over: every flax name maps, nothing is left over
    tb.load_state_dict(backbone_params_from_flax(jax.tree.map(np.asarray, params)),
                       strict=True)
    with torch.no_grad():
        got = tb({k: torch.from_numpy(v) for k, v in embs.items()},
                 {k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    f = len(CATS) + bool(conts)
    assert tb.top_0.weight.shape == (128, f * (f - 1) // 2 + (d if conts else 0))
    assert sorted(params) == sorted({n.split(".")[0] for n in tb.state_dict()})
    rtol, atol = TOL["logits"]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("threshold", [100, None])
def test_specs_and_stacked_collection_match(threshold):
    d = 16
    js = j_specs(SIZES, CATS, d, "row", fused_threshold=threshold)
    ts = t_specs(SIZES, CATS, d, "row", fused_threshold=threshold)
    assert [(s.name, s.num_embeddings, s.embedding_dim, s.features, s.fused,
             s.init_scale) for s in ts] == [
        (s.name, s.num_embeddings, s.embedding_dim, s.features, s.fused,
         s.init_scale) for s in js]
    jc = JColl(js, stack_tables=True, fused_kind="rowwise_adagrad")
    tc = TColl(ts, stack_tables=True, fused_kind="rowwise_adagrad")
    jt = jax.jit(jc.init)(jax.random.key(3))
    own = tc.init(0, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in jt.items()}
    assert "__tablestack_16_row_float32" in own
    assert ("__fatstack_16_row" in own) == (threshold is not None)
    for c in CATS:
        assert tc.resolve(c)[::2] == jc.resolve(c)[::2]
    for name in own:
        assert tc.array_embedding_dim(name) == jc.array_embedding_dim(name)
    tt = tables_from_numpy({k: np.asarray(v) for k, v in jt.items()})
    rng = np.random.default_rng(2)
    ids = {c: rng.integers(0, SIZES[c], 40).astype(np.int32) for c in CATS}
    want = jax.jit(jc.lookup)(jt, {k: jnp.asarray(v) for k, v in ids.items()})
    got = tc.lookup(tt, {k: torch.from_numpy(v) for k, v in ids.items()})
    for c in CATS:
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]))
