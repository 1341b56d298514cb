"""``tdfo_tpu_torch/ops/quant.py`` against ``tdfo_tpu/ops/quant.py``:
stochastic rounding and ``quantize`` bitwise equal for the same f32 input
and key; the identity on bf16-representable values; keyless
round-to-nearest; f32 passing through unchanged."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdfo_tpu.ops import quant as jq
from tdfo_tpu_torch.interop import bf16_bits
from tdfo_tpu_torch.ops import quant as tq


def _x(seed, shape=(37, 24)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 10.0 ** rng.integers(-4, 4, shape)
    x.flat[:4] = [0.0, -0.0, np.inf, -np.inf]
    return x.astype(np.float32)


@pytest.mark.parametrize("shape", [(5,), (37, 24), (3, 4, 5)])
def test_stochastic_round_bitwise(shape):
    for seed, step in ((0, 0), (1, 5), (2, 123456)):
        x = _x(seed, shape)
        jk, tk = jq.sr_key(step, "t"), tq.sr_key(step, "t")
        want = jq.stochastic_round(jnp.asarray(x), jnp.bfloat16, jk)
        got = tq.stochastic_round(torch.from_numpy(x), torch.bfloat16, tk)
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        np.testing.assert_array_equal(bf16_bits(got), bf16_bits(want))
        for i in range(3):
            want = jq.quantize(jnp.asarray(x), jnp.bfloat16, jq.component_key(jk, i))
            got = tq.quantize(torch.from_numpy(x), "bfloat16", tq.component_key(tk, i))
            np.testing.assert_array_equal(bf16_bits(got), bf16_bits(want))


def test_identity_on_representable_values():
    x = torch.from_numpy(_x(3)).to(torch.bfloat16)
    for step in range(5):
        got = tq.stochastic_round(x.float(), torch.bfloat16, tq.sr_key(step, "t"))
        np.testing.assert_array_equal(bf16_bits(got), bf16_bits(x))


def test_keyless_round_to_nearest_and_f32_passthrough():
    x = _x(4)
    got = tq.quantize(torch.from_numpy(x), torch.bfloat16)
    np.testing.assert_array_equal(bf16_bits(got), bf16_bits(jq.quantize(
        jnp.asarray(x), jnp.bfloat16)))
    np.testing.assert_array_equal(bf16_bits(got),
                                  bf16_bits(torch.from_numpy(x).to(torch.bfloat16)))
    xt = torch.from_numpy(x)
    for key in (None, tq.sr_key(1, "t")):
        out = tq.quantize(xt, torch.float32, key)
        assert out.dtype == torch.float32
        assert torch.equal(out.view(torch.int32), xt.view(torch.int32))
    # int8 needs its per-row sidecar: the reference's refusal
    with pytest.raises(ValueError, match="quantize_rows/dequantize_rows"):
        tq.quantize(xt, "int8")


def test_rounding_is_unbiased_and_lands_on_neighbours():
    """A value a quarter of the way between two bf16 neighbours lands on
    one of the two, on the upper about a quarter of the time."""
    x = torch.full((4096,), 1.0 + 2.0**-9, dtype=torch.float32)
    got = tq.stochastic_round(x, torch.bfloat16, tq.sr_key(9, "t")).float()
    assert set(got.unique().tolist()) <= {1.0, 1.0 + 2.0**-7}
    up = float((got > 1.0).float().mean())
    assert 0.2 < up < 0.3, up
