"""TwoTowerBackbone of the PyTorch port against the flax backbone: flax
params carried through ``interop`` give the same logits on a fixed batch
(rtol 1e-5 / atol 1e-6), and the collection's lookup reads JAX-made tables
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdfo_tpu.models.twotower import TwoTowerBackbone as JBackbone
from tdfo_tpu.models.twotower import ctr_embedding_specs as j_specs
from tdfo_tpu.parallel.embedding import ShardedEmbeddingCollection as JColl
from tdfo_tpu_torch.interop import TOL, backbone_params_from_flax, tables_from_numpy
from tdfo_tpu_torch.models.twotower import TwoTowerBackbone as TBackbone
from tdfo_tpu_torch.models.twotower import ctr_embedding_specs as t_specs
from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection as TColl

SIZE_MAP = {"user": 300, "item": 150, "language": 8, "is_ebook": 2,
            "format": 6, "publisher": 40, "pub_decade": 5}
COLS = {"user": "user_id", "item": "item_id", "language": "language",
        "is_ebook": "is_ebook", "format": "format", "publisher": "publisher",
        "pub_decade": "pub_decade"}


def _batch(rng, b):
    out = {c: rng.integers(0, SIZE_MAP[f], b).astype(np.int32)
           for f, c in COLS.items()}
    out["avg_rating"] = rng.random(b, dtype=np.float32)
    out["num_pages"] = rng.random(b, dtype=np.float32)
    out["label"] = rng.integers(0, 2, b).astype(np.float32)
    return out


@pytest.mark.parametrize("d", [16, 64])
def test_backbone_logits_match_flax(d):
    rng = np.random.default_rng(d)
    jb = JBackbone(embed_dim=d)
    embs = {c: rng.standard_normal((32, d)).astype(np.float32) for c in COLS.values()}
    batch = _batch(rng, 32)
    params = jb.init(jax.random.key(0),
                     {k: jnp.asarray(v) for k, v in embs.items()},
                     {k: jnp.asarray(batch[k]) for k in ("avg_rating", "num_pages")}
                     )["params"]
    want = np.asarray(jax.jit(jb.apply)({"params": params},
                               {k: jnp.asarray(v) for k, v in embs.items()},
                               {k: jnp.asarray(v) for k, v in batch.items()}))
    tb = TBackbone(d)
    tb.load_state_dict(backbone_params_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = tb({k: torch.from_numpy(v) for k, v in embs.items()},
                 {k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    assert tb.item_tower.fc1.weight.shape == (d, 6 * d + 2)
    rtol, atol = TOL["logits"]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("threshold", [100, 0, -1])
def test_collection_layout_and_lookup_match(threshold):
    """Same array names / shapes / offsets as the reference collection, and
    lookups of the reference's tables agree exactly (fat and plain)."""
    d = 16
    fused = None if threshold == -1 else threshold
    jc = JColl(j_specs(SIZE_MAP, d, "row", fused_threshold=fused))
    tc = TColl(t_specs(SIZE_MAP, d, "row", fused_threshold=fused))
    jt = jc.init(jax.random.key(3))
    tt_own = tc.init(0, device="cpu")
    assert {k: v.shape for k, v in tt_own.items()} == {
        k: tuple(v.shape) for k, v in jt.items()}
    for c in COLS.values():
        assert tc.resolve(c)[0] == jc.resolve(c)[0]
        assert tc.resolve(c)[2] == jc.resolve(c)[2]
    tt = tables_from_numpy({k: np.asarray(v) for k, v in jt.items()})
    ids = {c: np.random.default_rng(1).integers(0, SIZE_MAP[f], 40).astype(np.int32)
           for f, c in COLS.items()}
    want = jc.lookup(jt, {k: jnp.asarray(v) for k, v in ids.items()})
    got = tc.lookup(tt, {k: torch.from_numpy(v) for k, v in ids.items()})
    for k in COLS.values():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_entry_points_default_to_the_card():
    coll = TColl(t_specs(SIZE_MAP, 8, "row"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            coll.init(0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TColl(t_specs(SIZE_MAP, 8, "column"))
