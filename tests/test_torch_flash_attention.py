"""Port's flash attention against the JAX package: the port's plain version
(the CPU path of ``repro_torch.kernels.flash_attention.flash_attention``)
vs the reference Pallas kernel in interpret mode and vs ``attention_ref``,
over the grid of tests/test_kernels.py; the kernel's gradient rule
(``flash_vjp``) vs ``jax.vjp`` of the reference ``attention_ref``, and the
custom op's wiring. The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py (phase 3)."""

import math

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, flash_attention, flash_attention_kernel, flash_vjp)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402

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
    (2, 45, 45, 8, 2, 8, True, None),        # llama3-smoke heads: D=8
    (1, 100, 256, 4, 4, 64, False, None),    # cross-attention at prefill: Sq < Sk
    (4, 1, 256, 4, 4, 64, False, None),      # cross-attention at decode: Sq = 1
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


GRAD_TOL = dict(rtol=1e-4, atol=1e-4)    # float32 on both sides; sum order differs


@pytest.mark.parametrize("B,S,H,K,D,causal,window", [
    (2, 77, 4, 4, 16, True, None),       # G = 1, D = 16, ragged
    (1, 128, 8, 2, 64, True, None),      # G = 4, D = 64 (tiny's head_dim)
    (1, 96, 4, 1, 16, True, 32),         # G = 4, window (recurrentgemma-smoke heads)
    (2, 64, 4, 2, 64, True, 16),         # G = 2, D = 64, window
    (1, 80, 4, 4, 64, True, 24),         # G = 1, window
    (1, 50, 4, 2, 16, False, None),      # not causal
])
def test_flash_vjp_matches_jax_grad(B, S, H, K, D, causal, window):
    """flash_vjp (the kernel's backward) against jax.vjp of the reference's
    attention_ref for q, k and v, with the same masks and cotangent."""
    q, k, v = _inputs(B, S, S, H, K, D, seed=S + D)
    g = np.random.default_rng(S).standard_normal((B, S, H, D)).astype(np.float32)
    ref = jax.jit(lambda q, k, v, g: jax.vjp(
        lambda *x: jax_ref(*x, causal=causal, window=window), q, k, v)[1](g))(
        *(jnp.asarray(x) for x in (q, k, v, g)))
    ours = flash_vjp(torch.from_numpy(g), *(torch.from_numpy(x) for x in (q, k, v)),
                     causal=causal, window=window)
    for name, o, r in zip(("q", "k", "v"), ours, ref):
        assert o.shape == r.shape and o.dtype == torch.float32, name
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **GRAD_TOL, err_msg=name)


def test_flash_function_runs_kernel_forward_and_rule_backward(monkeypatch):
    """The custom op's wiring on the CPU: CPU tensors take the op's CUDA
    implementation for this test, with the kernel stood in for by the plain
    version. The forward calls the kernel once with the masks, the backward
    calls flash_vjp with them and gives autograd's gradients through
    attention_ref."""
    calls = []

    def fake_kernel(q, k, v, *, causal, window):
        calls.append(("kernel", causal, window))
        return attention_ref(q, k, v, causal=causal, window=window)

    def counted_vjp(*a, causal, window):
        calls.append(("vjp", causal, window))
        return flash_vjp(*a, causal=causal, window=window)

    monkeypatch.setattr(flash_ops, "flash_attention_kernel", fake_kernel)
    monkeypatch.setattr(flash_ops, "flash_vjp", counted_vjp)
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 40, 40, 4, 2, 16, seed=5))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    g = torch.randn(2, 40, 4, 16, generator=torch.Generator().manual_seed(0))
    flash_ops._flash_op.register_kernel("cpu", flash_ops._on_cuda)
    try:
        flash_ops.flash_attention(*a, causal=True, window=8).backward(g)
    finally:
        flash_ops._flash_op.register_kernel("cpu", flash_ops._on_cpu)
    attention_ref(*b, causal=True, window=8).backward(g)
    assert calls == [("kernel", True, 8), ("vjp", True, 8)]
    for ta, tb in zip(a, b):
        torch.testing.assert_close(ta.grad, tb.grad, rtol=1e-6, atol=1e-6)


def _flash_tc_emulation(q, k, v, *, causal, window, bk, round_p=True, scale=None):
    """A plain-torch emulation of the bf16 route of csrc/flash_attention.cu:
    S = Q K^T exact in f32 (products of bf16), online softmax over kv tiles
    of ``bk`` keys in base 2 (log2 e folded into the scale, D^-0.5 unless
    given), P rounded to bf16 for P V while l sums the unrounded P in f32, O
    in f32 until the single bf16 rounding of the output. ``round_p=False``
    keeps P in f32."""
    B, Sq, H, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    Sk, K = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)                                   # (B,H,Sq,D)
    kf = k.float().repeat_interleave(H // K, dim=2).transpose(1, 2)  # (B,H,Sk,D)
    vf = v.float().repeat_interleave(H // K, dim=2).transpose(1, 2)
    qpos = torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq), float("-inf"))
    l = torch.zeros((B, H, Sq))
    o = torch.zeros((B, H, Sq, D))
    for k0 in range(0, Sk, bk):
        s = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2) * (scale * math.log2(math.e))
        kpos = torch.arange(k0, min(Sk, k0 + bk))[None, :]
        ok = torch.ones_like(kpos - qpos, dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= qpos - kpos < window
        s = torch.where(ok, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        p = torch.exp2(s - m_use[..., None])
        alpha = torch.exp2(m - m_use)
        l = alpha * l + p.sum(-1)
        o = alpha[..., None] * o + (p.bfloat16().float() if round_p else p) @ vf[:, :, k0:k0 + bk]
        m = m_new
    out = torch.where(l[..., None] > 0, o / l.clamp(min=1e-30)[..., None], 0.0)
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("B,S,H,K,D,window,bk", [(1, 640, 8, 2, 128, None, 64),
                                                 (1, 600, 4, 1, 256, 256, 32)])
def test_tensor_core_rounding_stays_inside_the_card_tolerance(B, S, H, K, D, window, bk,
                                                              seed):
    """The bf16 route's roundings against attention_ref on bf16 inputs,
    under chip_smoke.py's bf16 tolerance (atol = rtol = 2e-2)."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(B, S, S, H, K, D, seed))
    ref = attention_ref(q, k, v, causal=True, window=window)
    out = _flash_tc_emulation(q, k, v, causal=True, window=window, bk=bk)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)


@pytest.mark.parametrize("B,Sq,Sk,H,causal", [(1, 1024, 1024, 4, False),
                                              (1, 340, 1024, 4, False),
                                              (4, 1, 1024, 4, False)])
def test_tensor_core_rounding_at_encoder_and_cross_attention_shapes(B, Sq, Sk, H, causal):
    """The bf16 route at seamless-m4t-large-v2's shapes (D=64, fewer heads):
    the encoder (not causal, 1024 x 1024), cross-attention at prefill (Sq <
    Sk, not causal) and at decode (Sq = 1), against attention_ref under
    chip_smoke.py's bf16 tolerance; every key is kept, so every kv tile adds
    to each row's sums."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(B, Sq, Sk, H, H, 64, seed=Sq))
    ref = attention_ref(q, k, v, causal=causal, window=None)
    out = _flash_tc_emulation(q, k, v, causal=causal, window=None, bk=64)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)


def test_tensor_core_emulation_without_rounding_matches_ref_in_f32():
    """The tiling, the masks and the base-2 online softmax alone, in f32
    with P unrounded: attention_ref to summation order."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 200, 200, 4, 2, 64, seed=3))
    ref = attention_ref(q, k, v, causal=True, window=96)
    out = _flash_tc_emulation(q, k, v, causal=True, window=96, bk=64, round_p=False)
    torch.testing.assert_close(out, ref, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_8_as_zero_filled_16_matches_ref(dtype):
    """Head dim 8 (llama3-smoke) as the kernel runs it: q, k and v
    zero-filled to 16 columns, the scale kept at 8^-0.5, and the first 8
    output columns kept. In f32 (P unrounded) it is attention_ref at D = 8
    to summation order; in bf16 the route's roundings stay inside the
    card's tolerance."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt) for a in _inputs(2, 77, 77, 8, 2, 8, seed=8))
    ref = attention_ref(q, k, v, causal=True, window=None)
    padded = [torch.nn.functional.pad(t, (0, 8)) for t in (q, k, v)]
    assert padded[0].shape[-1] == 16
    out = _flash_tc_emulation(*padded, causal=True, window=None, bk=64,
                              round_p=dtype == "bfloat16", scale=8 ** -0.5)
    assert out.dtype == dt and not out[..., 8:].any()
    torch.testing.assert_close(out[..., :8].float(), ref.float(),
                               **(TOL if dtype == "float32" else BF16_TOL))
