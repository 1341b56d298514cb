"""The port's ring attention (``parallel/ring_attention.py``) on four gloo
ranks (``tests/torch_dist_worker.py``, spawned once for the file) against
the JAX package's ``ring_self_attention`` on a ``MeshSpec(data=2, model=1,
seq=4)`` CPU mesh — the cases of ``tests/test_ring_attention.py``:

* unmasked and with key padding: rtol/atol 2e-5; every key masked gives 0
  and no NaN (ring and ring_flash);
* the gradients of ``sum(out ** 2)``: rtol 1e-5;
* T not divisible by the seq axis raises;
* bf16 operands: 2e-2, and the output stays bf16;
* ``block_k`` chunking equals the unchunked ring, outputs and gradients
  at rtol 1e-5;
* ``ring_flash`` (the flash kernels' plain versions on the CPU) against
  the ring: outputs 2e-5, gradients 5e-4, as in the reference;
* ``head_axis`` and ``batch_axis`` split the heads and the rows as the
  reference's do (meshes seq 2 x model 2 and data 2 x seq 2);
* Bert4Rec logits under ``ring`` and ``ring_flash`` against the
  reference's full-attention backbone: 3e-5 (no query row has every key
  masked: there full attention attends uniformly and the rings give 0).
"""

import functools
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_dist_worker import Ranks

from tdfo_tpu.core.config import MeshSpec
from tdfo_tpu.core.mesh import make_mesh
from tdfo_tpu.parallel.ring_attention import ring_self_attention

B, H, T, DH = 2, 2, 16, 8
SEQ4 = (1, 1, 4)


def _qkv(seed, b=B, h=H, t=T, dh=DH):
    rng = np.random.default_rng(seed)
    return {n: rng.normal(size=(b, h, t, dh)).astype(np.float32) for n in "qkv"}


def _valid(seed, p=0.3, t=T):
    v = np.random.default_rng(seed).random((B, t)) > p
    v[:, 0] = True  # at least one valid key per row
    return v


def _b4r_inputs():
    from tdfo_tpu.models.bert4rec import Bert4RecConfig, make_sharded_bert4rec

    cfg = dict(n_items=40, max_len=16, embed_dim=16, n_heads=2, n_layers=2,
               dropout=0.0)
    _, _, _, dense = make_sharded_bert4rec(
        jax.random.key(0), Bert4RecConfig(**cfg), None, sharding="replicated",
        attn="full")
    ids = np.array([[1, 2, 3, 4, 5, 41, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                    [7, 8, 9, 10, 11, 12, 13, 14, 15, 41, 0, 0, 0, 0, 0, 0]],
                   np.int32)
    embs = np.random.default_rng(9).uniform(-1, 1, (2, 16, 16)).astype(np.float32)
    return cfg, jax.tree.map(np.asarray, dense), ids, embs


@functools.lru_cache(maxsize=None)
def _runs():
    ranks = Ranks(4, Path(tempfile.mkdtemp(prefix="ring4_")))
    cfg, dense, ids, embs = _b4r_inputs()
    b4r = dict(fn="b4r_logits", mesh=SEQ4, cfg=cfg, dense=dense, ids=ids,
               embs=embs, sharding="replicated", fused_threshold=None,
               tables={"item_embedding": np.zeros((42, 16), np.float32)})
    blk = _qkv(5, t=32)
    cases = {
        "plain": dict(fn="ring", mesh=SEQ4, **_qkv(0)),
        "padded": dict(fn="ring", mesh=SEQ4, valid=_valid(0), **_qkv(1)),
        "all_masked": dict(fn="ring", mesh=SEQ4, valid=np.zeros((B, T), bool),
                           **_qkv(2)),
        "all_masked_flash": dict(fn="ring", mesh=SEQ4, impl="flash",
                                 valid=np.zeros((B, T), bool), **_qkv(2)),
        "grads": dict(fn="ring", mesh=SEQ4, grad=True, **_qkv(3)),
        "odd_t": dict(fn="ring", mesh=SEQ4, expect="ValueError", **_qkv(4, t=15)),
        "bf16": dict(fn="ring", mesh=SEQ4, bf16=True, **_qkv(6)),
        "unchunked": dict(fn="ring", mesh=SEQ4, grad=True, valid=_valid(5, t=32),
                          **blk),
        "chunked": dict(fn="ring", mesh=SEQ4, grad=True, valid=_valid(5, t=32),
                        block_k=4, **blk),
        "flash": dict(fn="ring", mesh=SEQ4, grad=True, impl="flash",
                      valid=_valid(4, 0.25), **_qkv(9)),
        "xla": dict(fn="ring", mesh=SEQ4, grad=True, valid=_valid(4, 0.25),
                    **_qkv(9)),
        "heads": dict(fn="ring", mesh=(1, 2, 2), grad=True, head_axis="model",
                      valid=_valid(7), **_qkv(10)),
        "rows": dict(fn="ring", mesh=(2, 1, 2), grad=True, batch_axis="data",
                     impl="flash", valid=_valid(8), **_qkv(11)),
        "b4r_ring": dict(b4r, attn="ring"),
        "b4r_ring_flash": dict(b4r, attn="ring_flash"),
    }
    ranks.send(cases)
    # the reference's side while the ranks run
    refs = {name: _ref(cases[name], **kw) for name, kw in _REF_KW.items()}
    refs["b4r"] = _ref_b4r(cases["b4r_ring"])
    return cases, refs, ranks.wait()


_REF_KW = {
    "plain": {}, "padded": {}, "bf16": {}, "grads": dict(grad=True),
    "chunked": dict(grad=True, block_k=4), "flash": dict(grad=True),
    "heads": dict(grad=True, head_axis="model", mesh=dict(data=1, model=2, seq=2)),
    # the reference's interpret-mode kernels are held to its ring at these
    # bounds; its ring is the reference here
    "rows": dict(grad=True, batch_axis="data", mesh=dict(data=2, model=1, seq=2)),
}


def _ref_b4r(case):
    from tdfo_tpu.models.bert4rec import (
        Bert4RecBackbone,
        Bert4RecConfig,
        key_padding_mask,
    )

    bb = Bert4RecBackbone(cfg=Bert4RecConfig(**case["cfg"]))
    return np.asarray(jax.jit(lambda e, i: bb.apply(
        {"params": case["dense"]}, e, key_padding_mask(i)))(
        jnp.asarray(case["embs"]), jnp.asarray(case["ids"])))


@functools.lru_cache(maxsize=None)
def _jmesh(data=2, model=1, seq=4):
    return make_mesh(MeshSpec(data=data, model=model, seq=seq),
                     devices=jax.devices()[:data * model * seq])


def _ref(case, grad=False, **kw):
    """The reference's ring on the case's inputs: ``(out, grads)``."""
    mesh = _jmesh(**kw.pop("mesh", {}))
    q, k, v = (jnp.asarray(case[n]) for n in "qkv")
    valid = None if case.get("valid") is None else jnp.asarray(case["valid"])
    if case.get("bf16"):
        q, k, v = (x.astype(jnp.bfloat16) for x in (q, k, v))
    fn = jax.jit(lambda q, k, v: ring_self_attention(mesh, q, k, v, valid, **kw))
    out = fn(q, k, v)
    if not grad:
        return np.asarray(out.astype(jnp.float32)), None
    g = jax.jit(jax.grad(lambda q, k, v: (fn(q, k, v) ** 2).sum(),
                         argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(x) for x in g]


def _rank_results(name):
    """``(reference (out, grads), rank 0's result)``; every rank holds the
    same global result."""
    _, refs, res = _runs()
    first = res[0][name]
    for r in res[1:]:
        np.testing.assert_array_equal(r[name]["out"], first["out"])
    return refs.get(name), first


@pytest.mark.parametrize("name", ["plain", "padded"])
def test_matches_the_reference(name):
    (want, _), got = _rank_results(name)
    np.testing.assert_allclose(got["out"], want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["all_masked", "all_masked_flash"])
def test_all_keys_masked_returns_zero(name):
    _, got = _rank_results(name)
    assert not np.isnan(got["out"]).any()
    np.testing.assert_array_equal(got["out"], 0.0)


def test_gradients_match_the_reference():
    (want, gw), got = _rank_results("grads")
    np.testing.assert_allclose(got["out"], want, rtol=2e-5, atol=2e-5)
    for a, b in zip(got["grads"], gw):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_rejects_indivisible_seq_len():
    _, _, res = _runs()
    for r in res:
        assert r["odd_t"]["raised"] == "ValueError"
        assert "not divisible" in r["odd_t"]["message"]


def test_bf16_operands():
    (want, _), got = _rank_results("bf16")
    assert got["dtype"] == "torch.bfloat16"
    np.testing.assert_allclose(got["out"], want, rtol=2e-2, atol=2e-2)


def test_block_k_chunking_matches_unchunked():
    _, full = _rank_results("unchunked")
    (want, gw), chunked = _rank_results("chunked")
    np.testing.assert_allclose(chunked["out"], full["out"], rtol=1e-5, atol=1e-6)
    for a, b in zip(chunked["grads"], full["grads"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(chunked["out"], want, rtol=2e-5, atol=2e-5)
    for a, b in zip(chunked["grads"], gw):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_ring_flash_matches_the_ring():
    (want, gw), flash = _rank_results("flash")
    _, xla = _rank_results("xla")
    np.testing.assert_allclose(flash["out"], xla["out"], rtol=2e-5, atol=2e-5)
    for a, b in zip(flash["grads"], xla["grads"]):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(flash["out"], want, rtol=2e-5, atol=2e-5)
    for a, b in zip(flash["grads"], gw):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("name", ["heads", "rows"])
def test_head_and_batch_axes_match_the_reference(name):
    (want, gw), got = _rank_results(name)
    np.testing.assert_allclose(got["out"], want, rtol=2e-5, atol=2e-5)
    for a, b in zip(got["grads"], gw):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("attn", ["ring", "ring_flash"])
def test_bert4rec_ring_logits_match_full(attn):
    _, refs, res = _runs()
    for r in res:
        np.testing.assert_allclose(r[f"b4r_{attn}"]["logits"], refs["b4r"],
                                   rtol=3e-5, atol=3e-5)
