"""The port's chunked attention (``ModelConfig.attn_chunked``) against the
JAX package: ``attention_chunked`` against the reference's on the cases of
tests/test_kernels.py, its gradient (autograd through its checkpointed
k-block steps, and ``flash_bwd_ref``, the backward kernel's plain version)
against ``jax.grad`` of the reference's; the flash op under ``chunked`` on
the CPU against the reference's ``flash_attention(chunked=True)``; the op's
wiring (the backward op under ``chunked``, ``flash_vjp`` without); a
train step of tiny-smoke and recurrentgemma-smoke with the flag against
the reference's; the config fields. The CUDA backward kernel is held
against ``flash_bwd_ref`` on the card by chip_smoke.py (phase 3)."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_chunked as jax_chunked  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_chunked, attention_ref, flash_attention, flash_bwd_ref, flash_vjp)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

FWD_TOL = dict(rtol=2e-5, atol=2e-5)     # tests/test_kernels.py's, float32
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)    # its chunked-gradient test's
TOL = dict(rtol=1e-4, atol=1e-4)         # tests/test_torch_train_dense_hybrid.py's


def _inputs(B, Sq, Sk, H, K, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Sk, K, D), np.float32),
            rng.standard_normal((B, Sk, K, D), np.float32),
            rng.standard_normal((B, Sq, H, D), np.float32))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("Sq,Sk,window,causal", [
    (256, 256, None, True),
    (512, 512, None, True),
    (512, 512, 200, True),     # sliding window
    (256, 256, None, False),
    (128, 384, None, True),    # q shorter than k: the bottom-right offset
])
def test_attention_chunked_matches_reference(Sq, Sk, window, causal):
    q, k, v, _ = _inputs(2, Sq, Sk, 4, 2, 32, seed=40 + Sq + Sk)
    ref = jax_chunked(q, k, v, causal=causal, window=window, q_block=128, k_block=128)
    out = attention_chunked(*_torch(q, k, v), causal=causal, window=window, q_block=128,
                            k_block=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("how", ["autograd", "flash_bwd_ref"])
def test_chunked_grad_matches_jax_grad(how):
    """tests/test_kernels.py's case: the gradient of sum(attention_chunked**2)
    with blocks of 64 over 256 positions."""
    q, k, v, _ = _inputs(1, 256, 256, 4, 2, 16, seed=42)
    ref = jax.grad(lambda *x: (jax_chunked(*x, q_block=64, k_block=64) ** 2).sum(),
                   argnums=(0, 1, 2))(q, k, v)
    x = [t.requires_grad_() for t in _torch(q, k, v)]
    o = attention_chunked(*x, q_block=64, k_block=64)
    if how == "autograd":
        (o ** 2).sum().backward()
        ours = [t.grad for t in x]
    else:
        ours = flash_bwd_ref(2 * o.detach(), *(t.detach() for t in x), causal=True,
                             window=None, q_block=64, k_block=64)
    for name, a, r in zip("qkv", ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL, err_msg=name)


def test_blocks_that_do_not_divide_give_attention_ref():
    """Blocks of 64 over 100 positions: the reference's own rule returns
    attention_ref, and the gradient is attention_ref's."""
    q, k, v, g = _inputs(1, 100, 100, 4, 2, 16, seed=7)
    tq, tk, tv, tg = _torch(q, k, v, g)
    out = attention_chunked(tq, tk, tv, window=30, q_block=64, k_block=64)
    assert torch.equal(out, attention_ref(tq, tk, tv, window=30))
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jax_chunked(q, k, v, window=30, q_block=64, k_block=64)), **FWD_TOL)
    ours = flash_bwd_ref(tg, tq, tk, tv, causal=True, window=30, q_block=64, k_block=64)
    for a, r in zip(ours, flash_vjp(tg, tq, tk, tv, causal=True, window=30)):
        torch.testing.assert_close(a, r, **GRAD_TOL)


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None),
                                           (False, 48)],
                         ids=["causal", "window", "full", "full-window"])
def test_flash_op_chunked_matches_reference(causal, window, G, D):
    """flash_attention(chunked=True) on the CPU, forward and gradient, against
    the reference's flash_attention(chunked=True, use_pallas=False) and its
    jax.vjp, with blocks of 32 over 128 positions."""
    B, S, K = 2, 128, 2
    q, k, v, g = _inputs(B, S, S, K * G, K, D, seed=D + 10 * G + (window or 0))
    fn = jax.jit(lambda q, k, v: jax_flash(q, k, v, causal=causal, window=window,
                                           chunked=True, q_chunk=32, k_chunk=32))
    ref, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    x = [t.requires_grad_() for t in _torch(q, k, v)]
    out = flash_attention(*x, causal=causal, window=window, chunked=True, q_block=32,
                          k_block=32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD_TOL)
    out.backward(torch.from_numpy(g))
    for name, a, r in zip("qkv", x, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), **GRAD_TOL, err_msg=name)


def test_chunked_refuses_causal_with_unequal_lengths():
    q, k, v, _ = _torch(*_inputs(1, 64, 128, 4, 2, 16, seed=0))
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(q, k, v, causal=True, chunked=True)
    flash_attention(q, k, v, causal=False, chunked=True)      # not causal: allowed


@pytest.mark.parametrize("chunked", [True, False])
def test_flash_op_backward_wiring(monkeypatch, chunked):
    """The custom ops' wiring on the CPU: CPU tensors take the ops' CUDA
    implementations for this test, with the kernels stood in for by their
    plain versions. Under ``chunked`` the backward calls the backward op's
    kernel once, with the saved output and the masks, and never flash_vjp;
    without it, flash_vjp once and never the backward op. Either way the
    gradients are autograd's through attention_ref."""
    calls = []

    def fake_kernel(q, k, v, *, causal, window):
        calls.append(("kernel", causal, window))
        return attention_ref(q, k, v, causal=causal, window=window)

    def fake_bwd_kernel(g, q, k, v, o, *, causal, window):
        calls.append(("bwd_kernel", causal, window))
        torch.testing.assert_close(o, attention_ref(q, k, v, causal=causal, window=window))
        return flash_bwd_ref(g, q, k, v, causal=causal, window=window)

    def counted_vjp(*a, causal, window):
        calls.append(("vjp", causal, window))
        return flash_vjp(*a, causal=causal, window=window)

    monkeypatch.setattr(flash_ops, "flash_attention_kernel", fake_kernel)
    monkeypatch.setattr(flash_ops, "flash_attention_bwd_kernel", fake_bwd_kernel)
    monkeypatch.setattr(flash_ops, "flash_vjp", counted_vjp)
    q, k, v, g = _torch(*_inputs(2, 40, 40, 4, 2, 16, seed=5))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_ops._flash_op.register_kernel("cpu", flash_ops._on_cuda)
    flash_ops._flash_bwd_op.register_kernel("cpu", flash_ops._bwd_on_cuda)
    try:
        flash_ops.flash_attention(*a, causal=True, window=8, chunked=chunked, q_block=8,
                                  k_block=8).backward(g)
    finally:
        flash_ops._flash_op.register_kernel("cpu", flash_ops._on_cpu)
        flash_ops._flash_bwd_op.register_kernel("cpu", flash_ops._bwd_on_cpu)
    attention_ref(*b, causal=True, window=8).backward(g)
    assert calls == [("kernel", True, 8), ("bwd_kernel" if chunked else "vjp", True, 8)]
    for ta, tb in zip(a, b):
        torch.testing.assert_close(ta.grad, tb.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["tiny", "recurrentgemma-2b"])
def test_chunked_train_step_matches_jax(arch):
    """The loss and every gradient leaf of one step with attn_chunked and
    blocks of 16 over 64 positions (recurrentgemma-smoke's window is 32),
    against jax.grad of the reference's loss with the same fields, on the
    port's seeded init carried across."""
    fields = dict(dtype="float32", attn_chunked=True, attn_q_block=16, attn_k_block=16)
    jcfg = jconfigs.get_smoke(arch).replace(**fields)
    tcfg = tconfigs.get_smoke(arch).replace(**fields)
    jparams = jax.tree_util.tree_map(
        jnp.asarray, interop.to_numpy(TM.init_params(tcfg, torch.Generator().manual_seed(0))))
    batch = {k: np.array(v) for k, v in jpipeline.make_batch(jcfg, 2, 64, seed=1,
                                                             step=0).items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(JM.loss_fn), static_argnums=1)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = interop.to_torch(jparams)
    leaves = dict(_leaves(tparams))
    for t in leaves.values():
        t.requires_grad_()
    loss = TM.loss_fn(tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    jflat = dict(_leaves(jgrads))
    assert sorted(jflat) == sorted(leaves)
    for path, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jflat[path]), **TOL,
                                   err_msg="/".join(path))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_config_fields_equal_the_reference():
    names = ("attn_chunked", "attn_q_block", "attn_k_block")
    ours = {f.name: f.default for f in ModelConfig.__dataclass_fields__.values()}
    ref = {f.name: f.default for f in JModelConfig.__dataclass_fields__.values()}
    assert {n: ours[n] for n in names} == {n: ref[n] for n in names} == \
        {"attn_chunked": False, "attn_q_block": 1024, "attn_k_block": 1024}
    for arch in jconfigs.ARCHS:
        assert not tconfigs.get(arch).attn_chunked and not jconfigs.get(arch).attn_chunked
