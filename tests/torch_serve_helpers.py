"""Shared constructors of the serving parity tests (``test_torch_serve_*.py``):
tiny JAX-side states and their carried-across port counterparts, and the
comparison rules.

Comparison rules (the port against the JAX package on the CPU):
  * bundles: the same manifest, array keys, dtypes, shapes and bytes, and
    the same digest;
  * logits: the ladder's forward rung (``interop.TOL["logits"]``);
  * retrieval: scores at rtol 1e-5; ids exactly at every rank whose score is
    separated from both neighbours by more than rtol 1e-5 (the neighbour
    below the last rank comes from the reference's full sort); ties held to
    the lower id by their own tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

SIZE_MAP = {"user": 300, "item": 260, "language": 8, "is_ebook": 2,
            "format": 8, "publisher": 40, "pub_decade": 16}
CAT_COLS = ("user_id", "item_id", "language", "is_ebook", "format",
            "publisher", "pub_decade")
CONT_COLS = ("avg_rating", "num_pages")
DIM = 16
RTOL = 1e-5


def ctr_batch(rng, n, sizes=SIZE_MAP):
    feats = {"user_id": "user", "item_id": "item", "language": "language",
             "is_ebook": "is_ebook", "format": "format",
             "publisher": "publisher", "pub_decade": "pub_decade"}
    out = {c: rng.integers(0, sizes[f], n).astype(np.int32)
           for c, f in feats.items()}
    out.update({c: rng.random(n).astype(np.float32) for c in CONT_COLS})
    return out


def jax_twotower(fused_threshold=None, seed=0, hot_ids=None, dtype=None,
                 fused_kind="adam"):
    """The reference's DMP TwoTower pieces: ``(coll, backbone, tables,
    dense_params)``."""
    import dataclasses

    from tdfo_tpu.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu.parallel.embedding import ShardedEmbeddingCollection

    specs = ctr_embedding_specs(SIZE_MAP, DIM, "row", fused_threshold=fused_threshold)
    if dtype is not None:
        specs = [dataclasses.replace(s, dtype=dtype) for s in specs]
    coll = ShardedEmbeddingCollection(specs, hot_ids=hot_ids, fused_kind=fused_kind)
    bb = TwoTowerBackbone(embed_dim=DIM)
    e = {f: jnp.zeros((1, DIM), jnp.float32) for f in coll.features()}
    c = {k: jnp.zeros((1,), jnp.float32) for k in CONT_COLS}
    dense = bb.init(jax.random.key(seed + 1), e, c)["params"]
    return coll, bb, coll.init(jax.random.key(seed)), dense


def port_twotower(jtables, jdense, fused_threshold=None, hot_ids=None,
                  dtype=None, fused_kind="adam"):
    """The port's collection, tables and backbone carrying the reference's
    arrays."""
    import dataclasses

    from tdfo_tpu_torch.interop import backbone_params_from_flax, tables_from_numpy
    from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    specs = ctr_embedding_specs(SIZE_MAP, DIM, "row", fused_threshold=fused_threshold)
    if dtype is not None:
        specs = [dataclasses.replace(s, dtype=dtype) for s in specs]
    coll = ShardedEmbeddingCollection(specs, hot_ids=hot_ids, fused_kind=fused_kind)
    bb = TwoTowerBackbone(DIM)
    bb.load_state_dict(backbone_params_from_flax(jax.tree.map(np.asarray, jdense)))
    return coll, tables_from_numpy({k: np.asarray(v) for k, v in jtables.items()}), bb


def twotower_export_kw(sizes=SIZE_MAP):
    return dict(model="twotower", embed_dim=DIM, cat_columns=CAT_COLS,
                cont_columns=CONT_COLS, size_map=sizes)


def assert_same_bundle(dir_a, dir_b):
    """Bitwise bundle identity: manifest, keys, dtypes, shapes, bytes, and
    the digest (inside the manifest, recomputed too)."""
    from tdfo_tpu_torch.serve.export import bundle_digest, read_raw_bundle

    ma, aa = read_raw_bundle(dir_a)
    mb, ab = read_raw_bundle(dir_b)
    assert ma == mb
    assert sorted(aa) == sorted(ab)
    for k in aa:
        assert aa[k].dtype == ab[k].dtype and aa[k].shape == ab[k].shape, k
        assert aa[k].tobytes() == ab[k].tobytes(), k
    assert ma["digest"] == bundle_digest(ma, aa) == bundle_digest(mb, ab)
    assert (dir_a / "bundle.json").read_text() == (dir_b / "bundle.json").read_text()


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return np.asarray(x)


def assert_retrieval_matches(got, want, ref_sorted, rtol=RTOL):
    """``got``/``want``: (scores [B, k], ids [B, k]); ``ref_sorted``: the
    reference's scores of its full descending sort [B, >= k+1].  Scores at
    ``rtol``; ids exactly wherever the rank is separated."""
    gs, gi = np_of(got[0]), np_of(got[1])
    ws, wi = np_of(want[0]), np_of(want[1])
    full = np_of(ref_sorted)
    k = ws.shape[1]
    np.testing.assert_allclose(gs, ws, rtol=rtol, atol=1e-6)
    checked = 0
    for b in range(ws.shape[0]):
        s = full[b, :k + 1]
        for r in range(k):
            tol = rtol * abs(s[r])
            above = r == 0 or s[r - 1] - s[r] > tol
            below = s[r] - s[r + 1] > tol
            if above and below:
                assert gi[b, r] == wi[b, r], (b, r, gi[b, r], wi[b, r])
                checked += 1
    assert checked > 0.5 * ws.size, checked  # the rule must bite
    return checked


class StubMesh:
    """A mesh of ``data`` ranks seen from rank ``index`` along it, without a
    process group: the serving paths that run no collective (loading a
    corpus shard, building a replicated scorer) read only its sizes and
    coordinates."""

    def __init__(self, data: int, index: int = 0):
        self.data, self.index = data, index

    def size(self, dim: int) -> int:
        return self.data if dim == 0 else 1

    def get_local_rank(self, axis: str) -> int:
        return self.index if axis == "data" else 0
