"""Port's training slice against the JAX package on mamba2-smoke at f32:
parameter shapes and count, forward logits and loss, the gradient of every
parameter leaf, 6 steps of the training loop (loss, grad_norm and lr per
step, and the final params) with the initial state carried by a step-0
checkpoint that one package writes and the other resumes from, in both
directions; preemption and resume; the data pipeline's tokens; and the
launcher on the CPU and without a card. The reference runs on
``jax.sharding.Mesh(... (1, 1), ("data", "model"))``: its step functions
refuse a ``jax.make_mesh`` mesh under JAX 0.9 (ROADMAP.md Queue 3)."""

import shutil

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import ParamSpec as JSpec  # noqa: E402
from repro.parallel import sharding as shd  # noqa: E402
from repro.parallel.steps import init_train_state as jax_init_state  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train.loop import train_loop as jax_train_loop  # noqa: E402
from repro.train.optimizer import OptConfig as JOpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import flatten_specs  # noqa: E402
from repro_torch.parallel.steps import init_train_state, make_train_step  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train.loop import train_loop  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)    # float32 on both sides; op order differs
ARCH = "mamba2-130m"
RUN = dict(steps=6, global_batch=4, seq_len=64, seed=0, log_every=1)


def _cfgs():
    return (jconfigs.get_smoke(ARCH).replace(dtype="float32"),
            tconfigs.get_smoke(ARCH).replace(dtype="float32"))


def _mesh():
    return Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))


def _jax_shapes(cfg):
    flat = jax.tree_util.tree_flatten_with_path(
        JM.param_shapes(cfg), is_leaf=lambda x: isinstance(x, JSpec))[0]
    return {tuple(k.key for k in path): tuple(spec.shape) for path, spec in flat}


@pytest.mark.parametrize("which", ["get", "get_smoke"])
def test_param_shapes_and_count_match_reference(which):
    jcfg, tcfg = getattr(jconfigs, which)(ARCH), getattr(tconfigs, which)(ARCH)
    assert tcfg.ssm_heads == jcfg.ssm_heads
    ours = {path: tuple(s.shape) for path, s in flatten_specs(TM.param_shapes(tcfg))}
    assert ours == _jax_shapes(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    if which == "get":
        assert tcfg.param_count() == 128_983_488


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = _cfgs()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.array(jpipeline.make_batch(jcfg, 3, 70, seed=1, step=0)["tokens"])
    return jcfg, tcfg, jparams, tokens


def test_forward_logits_and_loss_match_jax(smoke):
    jcfg, tcfg, jparams, tokens = smoke
    jlogits, _ = jax.jit(JM.forward, static_argnums=1)(jparams, jcfg,
                                                       {"tokens": jnp.asarray(tokens)})
    jloss = jax.jit(JM.loss_fn, static_argnums=1)(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    tparams = interop.to_torch(jparams)
    batch = {"tokens": torch.from_numpy(tokens)}
    logits, aux = TM.forward(tparams, tcfg, batch)      # (logits, aux), as the reference's
    assert logits.dtype == torch.float32 and logits.shape == (3, 70, tcfg.vocab_size)
    assert aux.dtype == torch.float32 and aux.item() == 0.0    # no experts
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(TM.loss_fn(tparams, tcfg, batch).item(), float(jloss), **TOL)


def test_every_grad_leaf_matches_jax_grad(smoke):
    jcfg, tcfg, jparams, tokens = smoke
    jgrads = jax.jit(jax.grad(JM.loss_fn), static_argnums=1)(
        jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    tparams = interop.to_torch(jparams)
    leaves = [(path, t.requires_grad_()) for path, t in _leaves(tparams)]
    TM.loss_fn(tparams, tcfg, {"tokens": torch.from_numpy(tokens)}).backward()
    jflat = dict(_leaves(jgrads))
    assert len(leaves) == len(jflat) == 11
    for path, t in leaves:
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jflat[path]), **TOL,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("mask_kind", ["random", "all_zero"])
def test_loss_mask_matches_jax(smoke, mask_kind):
    """With ``loss_mask`` the loss is the masked mean of the reference,
    mask[:, 1:] over max(its sum, 1); an all-zero mask gives 0."""
    jcfg, tcfg, jparams, tokens = smoke
    rng = np.random.default_rng(5)
    mask = (rng.random(tokens.shape) < 0.6) if mask_kind == "random" else \
        np.zeros(tokens.shape, bool)
    mask = mask.astype(np.int32)
    jloss = jax.jit(JM.loss_fn, static_argnums=1)(
        jparams, jcfg, {"tokens": jnp.asarray(tokens), "loss_mask": jnp.asarray(mask)})
    tparams = interop.to_torch(jparams)
    loss = TM.loss_fn(tparams, tcfg, {"tokens": torch.from_numpy(tokens),
                                      "loss_mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    if mask_kind == "all_zero":
        assert loss.item() == 0.0


def test_loss_with_all_ones_mask_equals_unmasked_loss(smoke):
    _, tcfg, jparams, tokens = smoke
    tparams = interop.to_torch(jparams)
    batch = {"tokens": torch.from_numpy(tokens)}
    plain = TM.loss_fn(tparams, tcfg, batch)
    ones = TM.loss_fn(tparams, tcfg, {**batch, "loss_mask": torch.ones(tokens.shape)})
    np.testing.assert_allclose(ones.item(), plain.item(), rtol=1e-6, atol=1e-6)


def test_jax_checkpoint_with_bf16_leaves_restores_the_same_bits(tmp_path):
    """The reference saves bf16 leaves through np.savez as 2-byte voids; the
    port restores them bit for bit (JAX -> port only: the reference cannot
    restore its own bf16 checkpoint)."""
    rng = np.random.default_rng(7)
    state = {"opt": {"mu": {"w": jnp.asarray(rng.standard_normal((5, 3)), jnp.bfloat16)}},
             "params": {"w": jnp.asarray(rng.standard_normal((5, 3)), jnp.float32)},
             "step": jnp.asarray(4, jnp.int32)}
    jckpt.save(str(tmp_path), state, 4)
    like = {"opt": {"mu": {"w": torch.empty((5, 3), dtype=torch.bfloat16)}},
            "params": {"w": torch.empty((5, 3))},
            "step": torch.empty((), dtype=torch.int32)}
    restored, step = tckpt.restore_latest(str(tmp_path), like)
    assert step == 4
    mu = restored["opt"]["mu"]["w"]
    assert mu.dtype == torch.bfloat16
    want = interop.to_torch(state)
    assert torch.equal(mu.view(torch.int16), want["opt"]["mu"]["w"].view(torch.int16))
    assert torch.equal(restored["params"]["w"], want["params"]["w"])
    assert restored["step"].item() == 4


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _final_state(ckpt_dir):
    step = tckpt.latest_step(ckpt_dir)
    with np.load(f"{ckpt_dir}/step_{step:08d}/state.npz") as data:
        return step, dict(data.items())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_train_loop_matches_jax_loop(tmp_path, writer):
    """The step-0 state is written by ``writer`` and both loops resume from
    it; then 6 steps at f32 on the same tokens."""
    jcfg, tcfg = _cfgs()
    init = tmp_path / "init"
    if writer == "jax":
        jckpt.save(str(init), jax_init_state(jcfg, jax.random.PRNGKey(3)), 0)
    else:
        tckpt.save(str(init), init_train_state(tcfg, torch.Generator().manual_seed(3)), 0)
    for d in ("jax", "port"):
        shutil.copytree(init, tmp_path / d)
    mesh = _mesh()
    jres = jax_train_loop(jcfg, mesh, shd.make_rules(multi_pod=False),
                          ckpt_dir=str(tmp_path / "jax"), opt=JOpt(warmup_steps=3), **RUN)
    tres = train_loop(tcfg, ckpt_dir=str(tmp_path / "port"), opt=OptConfig(warmup_steps=3),
                      device="cpu", **RUN)
    assert (tres.status, tres.step) == (jres.status, jres.step) == ("done", 6)
    assert [m["step"] for m in tres.history] == [m["step"] for m in jres.history] == list(range(6))
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([m[key] for m in tres.history],
                                   [m[key] for m in jres.history], **TOL, err_msg=key)
    assert max(m["grad_norm"] for m in tres.history) > 1.0     # the clip acts
    jstep, jfinal = _final_state(str(tmp_path / "jax"))
    tstep, tfinal = _final_state(str(tmp_path / "port"))
    assert jstep == tstep == 6 and sorted(jfinal) == sorted(tfinal)
    for key in jfinal:
        np.testing.assert_allclose(tfinal[key], jfinal[key], **TOL, err_msg=key)


def test_preempt_save_resume_repeats_the_curve(tmp_path):
    _, tcfg = _cfgs()
    run = dict(RUN, opt=OptConfig(warmup_steps=3), device="cpu")
    whole = train_loop(tcfg, ckpt_dir=str(tmp_path / "whole"), **run)
    calls = iter(range(100))
    first = train_loop(tcfg, ckpt_dir=str(tmp_path / "cut"),
                       preempt_check=lambda: next(calls) == 3, **run)
    assert (first.status, first.step) == ("preempted", 3)
    assert tckpt.list_steps(str(tmp_path / "cut")) == [3]
    rest = train_loop(tcfg, ckpt_dir=str(tmp_path / "cut"), **run)
    assert (rest.status, rest.step) == ("done", 6)
    curve = [m["loss"] for m in first.history + rest.history]
    np.testing.assert_allclose(curve, [m["loss"] for m in whole.history], rtol=1e-6, atol=1e-6)
    _, a = _final_state(str(tmp_path / "whole"))
    _, b = _final_state(str(tmp_path / "cut"))
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=1e-6, atol=1e-6, err_msg=key)


def test_microbatches_average_loss_and_grads():
    """Two microbatches of 2 rows give the mean of the two halves' losses
    and the mean of their gradients (the reference's accumulation)."""
    _, tcfg = _cfgs()
    tokens = tpipeline.make_batch(tcfg, 4, 33, seed=5, step=0)["tokens"]
    state = init_train_state(tcfg, torch.Generator().manual_seed(0))
    params = state["params"]
    losses = [TM.loss_fn(params, tcfg, {"tokens": tokens[i:i + 2]}) for i in (0, 2)]
    before = {k: v.clone() for k, v in params["layers"].items()}
    _, metrics = make_train_step(tcfg, microbatches=2)(
        state, {"tokens": tokens.reshape(2, 2, 33)})
    np.testing.assert_allclose(metrics["loss"].item(), (losses[0] + losses[1]).item() / 2,
                               rtol=1e-6)
    assert int(state["step"]) == 1
    assert not torch.equal(before["in_proj"], params["layers"]["in_proj"])


@pytest.mark.parametrize("seed,step,host,num_hosts", [(0, 0, 0, 1), (3, 17, 1, 2)])
def test_make_batch_gives_the_reference_tokens(seed, step, host, num_hosts):
    jcfg, tcfg = _cfgs()
    ref = jpipeline.make_batch(jcfg, 8, 64, seed=seed, step=step, host=host,
                               num_hosts=num_hosts)["tokens"]
    ours = tpipeline.make_batch(tcfg, 8, 64, seed=seed, step=step, host=host,
                                num_hosts=num_hosts)["tokens"]
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    it = tpipeline.data_iterator(tcfg, 8, 64, seed=seed, start_step=step)
    try:
        np.testing.assert_array_equal(next(it)["tokens"].numpy(), np.asarray(
            jpipeline.make_batch(jcfg, 8, 64, seed=seed, step=step)["tokens"]))
    finally:
        it.close()


def test_launcher_trains_on_cpu(capsys, tmp_path):
    # mamba2 is named: the default arch is tiny, as in the reference launcher
    result = launch_train.main(["--arch", "mamba2-130m", "--device", "cpu", "--steps", "3",
                                "--global-batch", "2", "--seq-len", "32",
                                "--ckpt-dir", str(tmp_path)])
    assert (result.status, result.step) == ("done", 3)
    assert all(np.isfinite(m["loss"]) for m in result.history)
    out = capsys.readouterr().out
    assert "arch=mamba2-smoke params=72,752 device=cpu dtype=float32" in out
    assert tckpt.list_steps(str(tmp_path)) == [3]


def test_launcher_without_card_or_cpu_flag_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(_cfgs()[1], steps=1, global_batch=2, seq_len=8)
