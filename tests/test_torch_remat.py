"""Remat, bf16 params and bf16 moments: the port against itself and against
the JAX package.

* Remat (``cfg.remat``, on by default as in the reference) recomputes each
  layer's forward in the backward: on and off give the same loss and
  gradients at tiny-smoke and recurrentgemma-smoke, and with it on every
  block runs twice.
* ``make_train_step(..., bf16_params=True)`` against the reference's on a
  1 x 1 ``jax.sharding.Mesh``, on carried weights and the same tokens, with
  bf16 activations (granite-smoke and recurrentgemma-smoke): the loss, the
  gradient norm and every gradient leaf (read from the first moment), and
  that the weights reaching the loss are bf16 with it and f32 without,
  while the masters and the gradients stay f32.
* ``adamw_update`` with ``moments_dtype="bfloat16"`` against the
  reference's, over three steps.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro.parallel.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.parallel.steps import init_train_state, make_train_step  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402


def _loss_and_grads(cfg, params, batch):
    leaves = topt.tree_leaves(params)
    for t in leaves:
        t.grad = None
        t.requires_grad_(True)
    loss = TM.loss_fn(params, cfg, batch)
    loss.backward()
    return loss.item(), [t.grad.clone() for t in leaves]


@pytest.mark.parametrize("arch", ["tiny", "recurrentgemma-2b"])
def test_remat_on_and_off_give_equal_loss_and_grads(arch, monkeypatch):
    cfg = tconfigs.get_smoke(arch).replace(dtype="float32")
    assert cfg.remat                          # the reference's default
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))}
    calls = []
    block_apply = tfm.block_apply
    monkeypatch.setattr(tfm, "block_apply",
                        lambda *a, **kw: calls.append(a[3]) or block_apply(*a, **kw))
    loss_on, grads_on = _loss_and_grads(cfg, params, batch)
    assert len(calls) == 2 * cfg.num_layers   # every layer's forward runs again
    calls.clear()
    loss_off, grads_off = _loss_and_grads(cfg.replace(remat=False), params, batch)
    assert len(calls) == cfg.num_layers
    assert loss_on == loss_off
    for a, b in zip(grads_on, grads_off):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# bf16 activations on both sides: each package rounds its bf16 ops on its
# own (XLA's CPU backend keeps some fused intermediates in f32), so they part
# by bf16 roundings (2^-8 of a value each): measured 2.4e-4 relative on the
# loss and 4.4e-3 on grad_norm at two layers; the limits leave 8x and 4x.
# Each gradient leaf is read from the first moment, mu = (1 - b1) g after
# step 0 in both packages, and compared by its relative L2 error: measured
# 0.017 (granite-smoke) and 0.063 (recurrentgemma-smoke, whose recurrences
# compound the roundings: the reference's own bf16 and f32 gradients part by
# 0.11 there, and the two packages in f32 by 3.3e-6). A gradient of the
# wrong sign is 2.0 off, a missing one 1.0.
BF16_LOSS_REL = 2e-3
BF16_GNORM_REL = 2e-2
BF16_GRAD_REL_L2 = 0.15


def _dtypes_reaching_the_loss(monkeypatch, cfg, state, tokens, bf16_params):
    """One port train step; the dtypes of the param leaves loss_fn was given."""
    seen, loss_fn = set(), TM.loss_fn

    def spy(params, cfg, mb):
        seen.update(t.dtype for t in topt.tree_leaves(params))
        return loss_fn(params, cfg, mb)

    monkeypatch.setattr(TM, "loss_fn", spy)
    new, metrics = make_train_step(cfg, bf16_params=bf16_params)(
        state, {"tokens": torch.from_numpy(tokens).long()})
    monkeypatch.setattr(TM, "loss_fn", loss_fn)
    return seen, new, metrics


@pytest.mark.parametrize("arch", ["granite-8b", "recurrentgemma-2b"])
def test_bf16_params_matches_the_reference(arch, monkeypatch):
    tcfg = tconfigs.get_smoke(arch)
    jcfg = jconfigs.get_smoke(arch).replace(use_pallas=False)
    assert tcfg.dtype == jcfg.dtype == "bfloat16"
    state = init_train_state(tcfg, torch.Generator().manual_seed(0))
    assert all(t.dtype == torch.float32 for t in topt.tree_leaves(state["params"]))
    jstate = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), interop.to_numpy(state))
    jstate["step"] = jnp.int32(0)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 40)).astype(np.int32)
    mesh = Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))
    jnew, jm = jax_make_train_step(jcfg, mesh, jshd.make_rules(multi_pod=False),
                                   bf16_params=True)(jstate, {"tokens": jnp.asarray(tokens)})
    off, _, _ = _dtypes_reaching_the_loss(
        monkeypatch, tcfg, init_train_state(tcfg, torch.Generator().manual_seed(0)), tokens,
        bf16_params=False)
    on, tnew, tm = _dtypes_reaching_the_loss(monkeypatch, tcfg, state, tokens,
                                             bf16_params=True)
    assert off == {torch.float32} and on == {torch.bfloat16}
    assert all(t.dtype == torch.float32
               for t in topt.tree_leaves({"p": tnew["params"], "o": tnew["opt"]}))
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=BF16_LOSS_REL)
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=BF16_GNORM_REL)
    jmu = interop.to_numpy(interop.to_torch(jax.device_get(jnew["opt"]["mu"])))
    for (path, t), (_, j) in zip(_flat(interop.to_numpy(tnew["opt"]["mu"])), _flat(jmu)):
        assert np.linalg.norm(t - j) <= BF16_GRAD_REL_L2 * np.linalg.norm(j), path


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_bf16_moments_match_the_reference_adamw():
    rng = np.random.default_rng(2)
    shapes = {"a": (64, 32), "b": {"c": (128,), "d": (8, 8, 4)}}

    def draw(scale):
        return topt.tree_map(lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
                             shapes, is_leaf=lambda x: isinstance(x, tuple))

    params = draw(1.0)
    toc = topt.OptConfig(moments_dtype="bfloat16", warmup_steps=2)
    joc = jopt.OptConfig(moments_dtype="bfloat16", warmup_steps=2)
    tp = topt.tree_map(torch.tensor, params)          # copies: the port updates in place
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tstate, jstate = topt.init_opt(tp, toc), jopt.init_opt(jp, joc)
    for step in range(3):
        grads = draw(0.5 * (step + 1))
        tp, tstate, tm = topt.adamw_update(topt.tree_map(torch.from_numpy, grads), tstate, tp,
                                           toc, torch.tensor(step, dtype=torch.int32))
        jp, jstate, jm = jopt.adamw_update(jax.tree_util.tree_map(jnp.asarray, grads), jstate,
                                           jp, joc, jnp.int32(step))
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-6)
    for name in ("mu", "nu"):
        for (_, t), (_, j) in zip(_flat(interop.to_numpy(tstate[name])),
                                  _flat(interop.to_numpy(interop.to_torch(
                                      jax.device_get(jstate[name]))))):
            assert t.dtype == np.float32     # bf16 widened by to_numpy, bits kept
            np.testing.assert_allclose(t, j, rtol=2 ** -8, atol=0)
    for (_, t), (_, j) in zip(_flat(interop.to_numpy(tp)), _flat(jax.device_get(jp))):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-6, atol=1e-7)
    assert all(t.dtype == torch.bfloat16 for t in topt.tree_leaves(tstate))
