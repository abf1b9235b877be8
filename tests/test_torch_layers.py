"""Port's common layers against the JAX package's, on the same numpy inputs:
rms_norm (float32 and bfloat16), rotary embedding + apply_rope, swiglu and
the embedding gather."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)     # float32, op order differs
BF16_TOL = dict(rtol=2e-2, atol=2e-2)    # one bf16 rounding of the output


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    x = _rng(1).standard_normal((2, 5, 64), np.float32) * 3
    scale = _rng(2).standard_normal(64).astype(np.float32)
    ref = JL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale), 1e-6)
    out = TL.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(scale), 1e-6)
    assert str(out.dtype).endswith(dtype)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    B, S, H, D = 2, 9, 3, 16
    pos = _rng(3).integers(0, 4000, (B, S))
    x = _rng(4).standard_normal((B, S, H, D), np.float32)
    js, jc = JL.rotary_embedding(jnp.asarray(pos), D, theta)
    ts, tc = TL.rotary_embedding(torch.from_numpy(pos), D, theta)
    # angles reach 4000 rad: float32 rounding of the angle bounds the error
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-4)
    ref = JL.apply_rope(jnp.asarray(x), js, jc)
    out = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(js)),
                        torch.from_numpy(np.array(jc)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


def _former_rotary_tables(positions, head_dim, theta):
    """The tables as the port built them before its base became a Python
    scalar: a float32 base tensor on the positions' device."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device),
                      exponent)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


# (head_dim, theta): granite-8b (the registry's 1e4 and the benchmark's 1e7),
# Moonlight's rope part (R = 64, 5e4), recurrentgemma-2b's local attention
@pytest.mark.parametrize("head_dim,theta", [(128, 1e4), (128, 1e7), (64, 5e4), (256, 1e4)])
def test_rotary_tables_are_bitwise_the_former_formula(head_dim, theta):
    decode = torch.from_numpy(_rng(9).integers(0, 8192, (128, 1)))
    for pos in (torch.arange(8192)[None, :], decode):
        new = TL.rotary_embedding(pos, head_dim, theta)
        for a, b in zip(new, _former_rotary_tables(pos, head_dim, theta)):
            assert a.dtype == torch.float32 and torch.equal(a, b)


def test_swiglu():
    g = _rng(5).standard_normal((3, 7, 32), np.float32) * 4
    u = _rng(6).standard_normal((3, 7, 32), np.float32)
    ref = JL.swiglu(jnp.asarray(g), jnp.asarray(u))
    out = TL.swiglu(torch.from_numpy(g), torch.from_numpy(u))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


def test_take_embedding():
    table = _rng(7).standard_normal((50, 16), np.float32)
    ids = _rng(8).integers(0, 50, (2, 6))
    ref = JL.take_embedding(jnp.asarray(table), jnp.asarray(ids), jnp.bfloat16)
    out = TL.take_embedding(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))
