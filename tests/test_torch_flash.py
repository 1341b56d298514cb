"""Flash attention of the PyTorch port against the JAX package, on the CPU.

The JAX side runs its Pallas kernels as its own tests do, in interpret
mode (``tests/test_pallas_kernels.py``); the port's wrappers take their
plain versions because the tensors lie on the CPU.  Inputs come from a
seeded numpy generator: key padding, one fully masked batch row (output 0,
``lse = +inf``, zero gradients) and T that is no multiple of the TPU's
blocks (the reference pads T, the port masks the ragged tile).  Forward and
lse at rtol/atol 2e-5 and gradients at 1e-4: the JAX tests' own bounds
(summation order only)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdfo_tpu.ops import pallas_kernels as jpk
from tdfo_tpu_torch.ops.kernels import flash_attention as fa

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(t, dh, seed=0):
    rng = np.random.default_rng(seed + 7 * t + dh)
    q, k, v, g = (rng.standard_normal((2, 2, t, dh)).astype(np.float32)
                  for _ in range(4))
    kv = rng.random((2, t)) > 0.3
    kv[0, 0] = True
    kv[1] = False  # a fully masked batch row
    return q, k, v, g, kv


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_fwd(q, k, v, kv, with_lse):
    return jpk._flash_fwd_impl(q, k, v, kv, 512, 512, True, with_lse=with_lse)


@jax.jit
def _jax_grads(q, k, v, kv, g):
    def f(q, k, v):
        return jnp.sum(jpk.flash_attention(q, k, v, kv, interpret=True) * g)

    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("t", [20, 64, 100])
@pytest.mark.parametrize("dh", [16, 32])
def test_forward_and_lse_match_jax(t, dh):
    q, k, v, _, kv = _inputs(t, dh)
    jo, jl = _jax_fwd(*map(jnp.asarray, (q, k, v, kv)), True)
    jl = np.asarray(jl)[:, :, 0, :]  # [B, H, 8, T] sublane broadcast -> [B, H, T]
    before = fa.flash_fwd.plain_runs
    launches = fa.flash_fwd.launches
    to, tl = fa.flash_fwd(*_t(q, k, v, kv))
    assert fa.flash_fwd.plain_runs == before + 1
    assert fa.flash_fwd.launches == launches  # no kernel ran
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(tl.numpy(), jl, **FWD_TOL)  # inf == inf
    assert np.isinf(tl[1].numpy()).all() and (to[1] == 0).all()
    # the inference call writes no lse and gives the same output
    jo2, _ = _jax_fwd(*map(jnp.asarray, (q, k, v, kv)), False)
    to2, none = fa.flash_fwd(*_t(q, k, v, kv), with_lse=False)
    assert none is None
    np.testing.assert_allclose(to2.numpy(), np.asarray(jo2), **FWD_TOL)


@pytest.mark.parametrize("t", [20, 100])
def test_gradients_match_jax_grad(t):
    dh = 32
    q, k, v, g, kv = _inputs(t, dh, seed=1)
    jg = _jax_grads(*map(jnp.asarray, (q, k, v, kv, g)))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    counts = [fa.flash_fwd.plain_runs, fa.flash_bwd_dq.plain_runs,
              fa.flash_bwd_dkv.plain_runs]
    out = fa.flash_attention(tq, tk, tv, torch.from_numpy(kv))
    (out * torch.from_numpy(g)).sum().backward()
    assert [fa.flash_fwd.plain_runs, fa.flash_bwd_dq.plain_runs,
            fa.flash_bwd_dkv.plain_runs] == [c + 1 for c in counts]
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    for x in (tq, tk, tv):  # the fully masked row gets no gradient
        assert (x.grad[1] == 0).all()


def test_plain_functions_compose_like_the_autograd_function():
    """``flash_attention_with_lse`` + ``flash_attention_bwd`` (the ring
    path's per-step pieces) give the autograd function's numbers, and no
    key mask means every key attends."""
    q, k, v, g, _ = _inputs(33, 16, seed=2)
    tq, tk, tv, tg = _t(q, k, v, g)
    out, lse = fa.flash_attention_with_lse(tq, tk, tv)
    dq, dk, dv = fa.flash_attention_bwd(tq, tk, tv, None, out, lse, tg)
    aq, ak, av = (x.clone().requires_grad_() for x in (tq, tk, tv))
    (fa.flash_attention(aq, ak, av) * tg).sum().backward()
    for a, b in ((dq, aq.grad), (dk, ak.grad), (dv, av.grad)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(lse).all()
    # without grad the inference forward runs (no lse write, same output)
    with torch.no_grad():
        torch.testing.assert_close(fa.flash_attention(tq, tk, tv), out,
                                   rtol=0, atol=0)


def test_bf16_plain_versions_round_like_the_kernels():
    """bf16 operands: p and ds are rounded to bf16 before their products
    and the result is cast back, f32 accumulation in between, as the
    reference; against an f32 run of the same (bf16-exact) inputs the
    difference is bf16-sized, never larger."""
    q, k, v, g, kv = _inputs(24, 16, seed=3)
    tb = [x.to(torch.bfloat16) for x in _t(q, k, v, g)]
    tf = [x.float() for x in tb]
    kv = torch.from_numpy(kv)
    ob, lb = fa.flash_fwd_plain(*tb[:3], kv)
    of, lf = fa.flash_fwd_plain(*tf[:3], kv)
    assert ob.dtype == torch.bfloat16 and lb.dtype == torch.float32
    torch.testing.assert_close(ob.float(), of, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lb, lf, rtol=1e-5, atol=1e-5)
    delta = (tb[3].float() * ob.float()).sum(-1)
    dkb, dvb = fa.flash_bwd_dkv_plain(*tb[:3], tb[3], kv, lb, delta)
    dkf, dvf = fa.flash_bwd_dkv_plain(*tf[:3], tf[3], kv, lb, delta)
    assert dkb.dtype == dvb.dtype == torch.bfloat16
    torch.testing.assert_close(dvb.float(), dvf, rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(dkb.float(), dkf, rtol=3e-2, atol=3e-2)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros((1, 1, 8, 12))
    kv = torch.ones((1, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="Dh"):
        fa.flash_fwd(q, q, q, kv)  # Dh 12: no multiple of 8
    q = torch.zeros((1, 1, 8, 136))
    with pytest.raises(ValueError, match="Dh"):
        fa.flash_fwd(q, q, q, kv)  # Dh > 128
    q = torch.zeros((1, 1, 8, 16))
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(q.half(), q.half(), q.half(), kv)
    with pytest.raises(ValueError, match="key_valid"):
        fa.flash_fwd(q, q, q, kv.float())
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd_dq(q, q, q, q, kv, torch.zeros((1, 1, 7)),
                        torch.zeros((1, 1, 8)))
