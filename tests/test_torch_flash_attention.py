"""Port's flash attention against the JAX package: the port's plain version
(the CPU path of ``repro_torch.kernels.flash_attention.flash_attention``)
vs the reference Pallas kernel in interpret mode and vs ``attention_ref``,
over the grid of tests/test_kernels.py. The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py (phase 3)."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention, flash_attention_kernel)

# tests/test_kernels.py TOL for float32 (summation order differs).
TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)   # output rounding to bf16


def _inputs(B, Sq, Sk, H, K, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Sk, K, D), np.float32),
            rng.standard_normal((B, Sk, K, D), np.float32))


CASES = [
    # B, Sq, Sk, H, K, D, causal, window
    (1, 128, 128, 4, 4, 64, True, None),     # MHA square
    (2, 256, 256, 8, 2, 64, True, None),     # GQA 4:1
    (1, 128, 384, 4, 1, 128, True, None),    # MQA, Sk > Sq, head_dim 128
    (2, 384, 384, 6, 2, 32, True, None),     # non-pow2 heads, 3 k-blocks
    (1, 384, 384, 4, 2, 64, True, 64),       # sliding window
    (1, 384, 384, 4, 2, 64, True, 256),
    (1, 256, 256, 4, 4, 64, False, None),    # non-causal
    (1, 37, 37, 4, 2, 16, True, None),       # ragged: below one block
    (1, 200, 200, 4, 2, 16, True, None),     # ragged: 1.56 blocks
    (1, 100, 150, 4, 2, 32, False, None),    # ragged, Sq != Sk, non-causal
    (1, 200, 200, 2, 1, 256, True, 64),      # recurrentgemma heads: MQA, D=256, window
]


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window", CASES)
def test_plain_matches_pallas_and_ref(B, Sq, Sk, H, K, D, causal, window):
    q, k, v = _inputs(B, Sq, Sk, H, K, D, seed=Sq + 7 * H + D)
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, window=window, use_pallas=True)
    ref = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_plain_bf16_matches_ref():
    q, k, v = _inputs(1, 128, 128, 4, 2, 64, seed=11)
    ref = jax_ref(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                  jnp.asarray(v, jnp.bfloat16))
    out = attention_ref(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **BF16_TOL)


def test_kernel_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 1, 16, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q, k, v)

