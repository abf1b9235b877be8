"""Port's continuous-batching engine against the JAX package's, on the same
weights and prompts; the port's launcher on the CPU; and the refusal to run
on a card that is not there."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import sharding as shd  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402


def _requests():
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 256, int(rng.integers(3, 20))).tolist(),
             int(rng.integers(2, 8))) for _ in range(5)]
    reqs.append((rng.integers(0, 256, 40).tolist(), 12))   # stops at max_len - 1
    return reqs


ARCHS = ["granite-8b", "recurrentgemma-2b", "mamba2-130m", "qwen2.5-14b",
         "mistral-nemo-12b", "llama3-405b", "mixtral-8x22b", "moonshot-v1-16b-a3b",
         "internvl2-26b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax_engine(arch):
    """Prompts of 3-40 tokens: the longest pass recurrentgemma-smoke's and
    mixtral-smoke's window of 32, so their rings roll at prefill, and
    mamba2-smoke's chunk of 32, so its prefill scan carries state across
    chunks; idle rows' SSM states advance in decode and are overwritten at
    admission, as in the reference. qwen2.5-smoke runs the QKV biases,
    mistral-nemo-smoke rope_theta 1e6, llama3-smoke head_dim 8 and 5e5;
    the MoE prefills are batch-1 at the prompt's length, and decode at
    batch 2 takes mixtral-smoke's dense path (B·k = E) and moonshot-smoke's
    gather path (B·k < E). internvl2-smoke's prefills prepend 8 zero vision
    embeddings (a slot's positions count them, so the longest prompt's
    prefill rolls its cache ring), seamless-smoke's encode 16 zero speech
    frames for the cross-attention."""
    jcfg = jconfigs.get_smoke(arch).replace(dtype="float32")
    tcfg = tconfigs.get_smoke(arch).replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    mesh = Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))
    jeng = JaxEngine(jcfg, mesh, shd.make_rules(multi_pod=False), jparams,
                     max_batch=2, max_len=48)
    teng = ServeEngine(tcfg, interop.to_torch(jparams), max_batch=2,
                       max_len=48, device="cpu")
    for prompt, n in _requests():
        jeng.submit(prompt, max_new_tokens=n)
        teng.submit(prompt, max_new_tokens=n)
    with mesh:
        jdone = jeng.run(max_steps=200)
    tdone = teng.run(max_steps=200)
    assert [r.generated for r in tdone] == [r.generated for r in jdone]
    assert all(r.done for r in tdone)
    assert teng.steps_run == jeng.steps_run
    assert len(tdone[-1].generated) < 12          # the max_len - 1 stop fired


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_runs_on_cpu(capsys, arch):
    done = launch_serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                              "--max-len", "32", "--max-new", "4"])
    assert len(done) == 3 and all(r.done and r.generated for r in done)
    out = capsys.readouterr().out
    assert "device=cpu served 3 requests" in out
    assert f"arch={tconfigs.get_smoke(arch).name}" in out


def test_no_card_and_no_cpu_flag_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "recurrentgemma-2b", "--requests", "1"])
    cfg = tconfigs.get_smoke("granite-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, {}, max_batch=1, max_len=8)
