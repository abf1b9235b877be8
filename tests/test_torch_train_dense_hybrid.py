"""Port's dense and hybrid training against the JAX package at f32, on
tiny-smoke, granite-smoke and recurrentgemma-smoke: tiny's parameter shapes
and count; forward logits and loss; the gradient of every parameter leaf
against ``jax.grad``; 6 steps of the training loop (loss, grad_norm and lr
per step, and the final params) from a step-0 checkpoint that one package
writes and both loops resume from; and the launcher on the CPU.

The weights are the port's own seeded init, carried to the JAX package.
The reference's init draws every stacked weight with std num_layers^-0.5
(ROADMAP.md Queue 3), 0.71 instead of 0.125 at two layers of width 64, and
its attention scores then run about 30x larger; there float32 rounding in
either package moves the softmax's gradient by about 1e-4 of its scale
against a float64 evaluation, and tiny-smoke's embedding gradient differs
between the two by 5.7e-4 at a largest entry of 7.35. The mamba2-smoke and
serving tests, which have no such scores, keep the reference's init.

On the CPU attention and the RG-LRU scan run their plain versions, and
autograd differentiates them; the kernels' gradient rules are tested in
test_torch_flash_attention.py and test_torch_rglru.py, and on the card by
chip_smoke.py. The reference runs on ``jax.sharding.Mesh(... (1, 1),
("data", "model"))``: its step functions refuse a ``jax.make_mesh`` mesh
under JAX 0.9 (ROADMAP.md Queue 3)."""

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
from repro.train.loop import train_loop as jax_train_loop  # noqa: E402
from repro.train.optimizer import OptConfig as JOpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import flatten_specs  # noqa: E402
from repro_torch.parallel.steps import init_train_state  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train.loop import train_loop  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)    # float32 on both sides; op order differs
ARCHS = ["tiny", "granite-8b", "recurrentgemma-2b", "qwen2.5-14b", "mixtral-8x22b",
         "internvl2-26b", "seamless-m4t-large-v2"]
# parameter leaves: stacked (tiny, granite, internvl2; qwen2.5 adds the three
# QKV biases; mixtral has the router and three expert weights for the MLP's
# three) or unrolled over 5 layers of rglru, rglru, local_attn, rglru, rglru
# (recurrentgemma, tied embeddings); seamless: 13 per decoder layer (the
# cross block's norm and four projections, a gelu MLP of two), 8 per
# encoder layer and the encoder's final norm, and embed, unembed, final norm
N_LEAVES = {"tiny": 12, "granite-8b": 12, "recurrentgemma-2b": 4 * 13 + 9 + 2,
            "qwen2.5-14b": 15, "mixtral-8x22b": 13, "internvl2-26b": 12,
            "seamless-m4t-large-v2": 13 + 9 + 3}
RUN = dict(steps=6, global_batch=4, seq_len=48, seed=0, log_every=1)


def _cfgs(arch):
    return (jconfigs.get_smoke(arch).replace(dtype="float32"),
            tconfigs.get_smoke(arch).replace(dtype="float32"))


def _mesh():
    return Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))


def _jax_shapes(cfg):
    flat = jax.tree_util.tree_flatten_with_path(
        JM.param_shapes(cfg), is_leaf=lambda x: isinstance(x, JSpec))[0]
    return {tuple(k.key for k in path): tuple(spec.shape) for path, spec in flat}


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


@pytest.mark.parametrize("which", ["get", "get_smoke"])
def test_tiny_param_shapes_and_count_match_reference(which):
    jcfg, tcfg = getattr(jconfigs, which)("tiny"), getattr(tconfigs, which)("tiny")
    assert tcfg == tcfg.replace(**{f: getattr(jcfg, f) if hasattr(jcfg, f)
                                       else tcfg.__dataclass_fields__[f].default
                                    for f in tcfg.__dataclass_fields__})
    ours = {path: tuple(s.shape) for path, s in flatten_specs(TM.param_shapes(tcfg))}
    assert ours == _jax_shapes(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    if which == "get":
        assert tcfg.param_count() == 65_020_416


def _port_init(tcfg, seed):
    return TM.init_params(tcfg, torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = jax.tree_util.tree_map(jnp.asarray, interop.to_numpy(_port_init(tcfg, 0)))
    # longer than recurrentgemma-smoke's window of 32; internvl2-smoke's 45
    # positions are 8 vision embeddings and 37 tokens, seamless-smoke's batch
    # carries 16 speech-frame embeddings beside its 45 tokens
    batch = {k: np.array(v) for k, v in jpipeline.make_batch(jcfg, 3, 45, seed=1,
                                                             step=0).items()}
    return request.param, jcfg, tcfg, jparams, batch


def test_forward_logits_and_loss_match_jax(smoke):
    _, jcfg, tcfg, jparams, nbatch = smoke
    batch = {k: jnp.asarray(v) for k, v in nbatch.items()}
    jlogits, jaux = jax.jit(JM.forward, static_argnums=1)(jparams, jcfg, batch)
    jloss = jax.jit(JM.loss_fn, static_argnums=1)(jparams, jcfg, batch)
    tparams = interop.to_torch(jparams)
    tbatch = {k: torch.from_numpy(v) for k, v in nbatch.items()}
    logits, aux = TM.forward(tparams, tcfg, tbatch)     # (logits, aux), as the reference's
    assert logits.dtype == torch.float32 and logits.shape == (3, 45, tcfg.vocab_size)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(TM.loss_fn(tparams, tcfg, tbatch).item(), float(jloss), **TOL)


def test_every_grad_leaf_matches_jax_grad(smoke):
    arch, jcfg, tcfg, jparams, nbatch = smoke
    jgrads = jax.jit(jax.grad(JM.loss_fn), static_argnums=1)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in nbatch.items()})
    tparams = interop.to_torch(jparams)
    leaves = [(path, t.requires_grad_()) for path, t in _leaves(tparams)]
    TM.loss_fn(tparams, tcfg, {k: torch.from_numpy(v) for k, v in nbatch.items()}).backward()
    jflat = dict(_leaves(jgrads))
    assert len(leaves) == len(jflat) == N_LEAVES[arch]
    for path, t in leaves:
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jflat[path]), **TOL,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loop_matches_jax_loop(tmp_path, arch):
    """The step-0 state (the port's seeded init) is written by the port and
    both loops resume from it; then 6 steps at f32 on the same tokens."""
    jcfg, tcfg = _cfgs(arch)
    init = tmp_path / "init"
    tckpt.save(str(init), init_train_state(tcfg, torch.Generator().manual_seed(3)), 0)
    for d in ("jax", "port"):
        shutil.copytree(init, tmp_path / d)
    jres = jax_train_loop(jcfg, _mesh(), shd.make_rules(multi_pod=False),
                          ckpt_dir=str(tmp_path / "jax"), opt=JOpt(warmup_steps=3), **RUN)
    tres = train_loop(tcfg, ckpt_dir=str(tmp_path / "port"), opt=OptConfig(warmup_steps=3),
                      device="cpu", **RUN)
    assert (tres.status, tres.step) == (jres.status, jres.step) == ("done", 6)
    assert [m["step"] for m in tres.history] == [m["step"] for m in jres.history] == list(range(6))
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([m[key] for m in tres.history],
                                   [m[key] for m in jres.history], **TOL, err_msg=key)
    jstep, jfinal = _final_state(str(tmp_path / "jax"))
    tstep, tfinal = _final_state(str(tmp_path / "port"))
    assert jstep == tstep == 6 and sorted(jfinal) == sorted(tfinal)
    for key in jfinal:
        np.testing.assert_allclose(tfinal[key], jfinal[key], **TOL, err_msg=key)


@pytest.mark.parametrize("arch", ["tiny", "recurrentgemma-2b"])
def test_launcher_trains_on_cpu(capsys, tmp_path, arch):
    result = launch_train.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                                "--global-batch", "4", "--seq-len", "32",
                                "--microbatches", "2", "--ckpt-dir", str(tmp_path)])
    assert (result.status, result.step) == ("done", 3)
    assert all(np.isfinite(m["loss"]) for m in result.history)
    # tiny trains its published config, as the reference launcher does
    cfg = tconfigs.get(arch) if arch == "tiny" else tconfigs.get_smoke(arch)
    out = capsys.readouterr().out
    assert f"arch={cfg.name} params={cfg.param_count():,} device=cpu dtype=float32" in out
    if arch == "tiny":
        assert "arch=tiny params=65,020,416 " in out
    assert tckpt.list_steps(str(tmp_path)) == [3]
