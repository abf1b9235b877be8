"""The port's span recorder (``repro_torch.obs``) and the serving
engine's spans in it, on the CPU: granite-smoke in float32 with more requests
than slots. Each admitted request's queued, prefill and hold spans tile its
time from ``submit()`` to its step's return; each step records the queue it
found; the buffer keeps its bound; mapped spans meet ``torch.profiler``
ranges opened beside them; and the launcher prints the summary and writes
the spans as a Chrome trace."""

import json

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

REQUEST_SPANS = ("serve.request.queued", "serve.request.prefill", "serve.request.hold")


@pytest.fixture
def rec(monkeypatch):
    r = obs.Recorder()
    monkeypatch.setattr(obs, "RECORDER", r)
    return r


def _engine():
    cfg = tconfigs.get_smoke("granite-8b").replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    return ServeEngine(cfg, params, max_batch=2, max_len=48, device="cpu")


def _serve(engine):
    """Six requests into two slots, one of them done at its admission; the
    queue's length before each step."""
    rng = np.random.default_rng(3)
    for n in (5, 1, 3, 4, 2, 6):
        engine.submit(rng.integers(0, 256, int(rng.integers(3, 20))).tolist(),
                      max_new_tokens=n)
    queues = []
    while engine.queue or any(s.active for s in engine.slots):
        queues.append(len(engine.queue))
        engine.step()
    return queues


def _named(rec, name):
    return [s for s in rec.spans if s.name == name]


def test_each_request_has_queued_prefill_and_hold_spans_that_tile_its_wait(rec):
    engine = _engine()
    _serve(engine)
    steps = {s.id: s for s in _named(rec, "serve.step")}
    assert len(engine.requests) == 6 and all(r.done for r in engine.requests.values())
    for rid in engine.requests:
        queued, prefill, hold = ([s for s in rec.spans if s.name == n and s.rid == rid]
                                 for n in REQUEST_SPANS)
        assert len(queued) == len(prefill) == len(hold) == 1, rid
        (queued,), (prefill,), (hold,) = queued, prefill, hold
        assert queued.parent == prefill.parent == hold.parent
        step = steps[queued.parent]
        assert step.attrs["admitted"] >= 1
        assert queued.start <= queued.end == prefill.start <= prefill.end == hold.start
        assert hold.end == step.end and step.start <= prefill.start
        assert prefill.attrs["tokens"] == len(engine.requests[rid].prompt)
    # rids 2.. wait for a slot across steps: two slots, six requests
    waits = [s.end - s.start for s in _named(rec, "serve.request.queued")]
    assert max(waits) > 10 * min(waits)


def test_steps_record_the_queue_they_found_and_their_decode(rec):
    engine = _engine()
    queues = _serve(engine)
    steps = _named(rec, "serve.step")
    assert [s.attrs["queue"] for s in steps] == queues
    assert [s.attrs["index"] for s in steps] == sorted(s.attrs["index"] for s in steps)
    decodes = _named(rec, "serve.decode")
    assert len(decodes) == engine.steps_run
    assert sum(s.attrs["admitted"] for s in steps) == len(engine.requests)
    by_id = {s.id: s for s in steps}
    for d in decodes:
        step = by_id[d.parent]
        assert step.start <= d.start <= d.end <= step.end
        assert 1 <= d.attrs["active"] <= 2 and d.attrs["contexts"] >= d.attrs["active"]
        assert d.attrs["graph"] == 0            # the CPU step runs eagerly
    assert engine.serve_step.captures == engine.serve_step.replays == 0
    # a step with no slot left active records no decode (request 1 is done at admission)
    assert len(steps) >= len(decodes)


@pytest.mark.parametrize("arch", ["granite-8b", "recurrentgemma-2b", "moonlight-16b-a3b"])
def test_the_serve_step_on_the_cpu_is_the_models_decode_step(arch):
    """Logits and every cache leaf equal to ``M.decode_step``'s, bit for bit,
    over three steps on a cache of random contents; nothing is captured."""
    from repro_torch.parallel.steps import make_serve_step
    from repro_torch.train.optimizer import tree_leaves
    cfg = tconfigs.get_smoke(arch).replace(dtype="float32")
    gen = torch.Generator().manual_seed(5)
    params = M.init_params(cfg, gen, torch.float32, "cpu")
    cache = M.init_cache(cfg, 3, 24)
    for t in tree_leaves(cache):
        t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    ref_cache = {"layers": {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                                else v.clone()) for k, v in cache["layers"].items()}}
    step = make_serve_step(cfg)
    pos = torch.tensor([4, 11, 0])
    for _ in range(3):
        tokens = torch.randint(0, cfg.vocab_size, (3, 1), generator=gen)
        logits, out_cache = step(params, cache, tokens, pos)
        with torch.inference_mode():
            ref, _ = M.decode_step(params, cfg, ref_cache, tokens, pos)
        assert out_cache is cache and torch.equal(logits, ref)
        for a, b in zip(tree_leaves(cache), tree_leaves(ref_cache)):
            assert torch.equal(a, b)
        pos = pos + 1
    assert step.captures == step.replays == 0


def test_the_serve_step_carries_every_kernel_wrappers_launch_count():
    """A replay launches through no wrapper, so the serve step adds the
    capture's counts to the wrappers on each replay: it must know every
    counter that a wrapper of the port keeps."""
    import importlib
    import pkgutil

    import repro_torch.kernels as kernels
    from repro_torch.parallel.steps import LAUNCH_COUNTERS
    found = set()
    for info in pkgutil.iter_modules(kernels.__path__):
        if not info.ispkg:
            continue
        mod = importlib.import_module(f"repro_torch.kernels.{info.name}.kernel")
        for fn in vars(mod).values():
            if callable(fn) and getattr(fn, "__module__", None) == mod.__name__:
                found |= {(fn, n) for n in ("launches", "combine_launches")
                          if isinstance(getattr(fn, n, None), int)}
    assert len(found) == 8 and found == set(LAUNCH_COUNTERS)


# (arch, dtype, whether a decode step reads the host): only the dropless
# experts outside bf16 run the experts loop, which reads its offsets
@pytest.mark.parametrize("arch,dtype,reads", [
    ("moonlight-16b-a3b", "bfloat16", False), ("moonlight-16b-a3b", "float32", True),
    ("mixtral-8x22b", "float32", False), ("granite-8b", "float32", False)])
def test_only_the_dropless_experts_loop_keeps_the_decode_step_eager(arch, dtype, reads):
    from repro_torch.models import moe
    cfg = tconfigs.get_smoke(arch).replace(dtype=dtype)
    assert moe.decode_reads_host(cfg, M.compute_dtype(cfg)) is reads


def test_the_buffer_keeps_its_bound_and_counts_what_it_drops():
    r = obs.Recorder(capacity=4)
    for i in range(10):
        r.record("x", 10 * i, 10 * i + 5, rid=i)
    assert len(r.spans) == 4 and r.dropped == 6 and r.dropped_end == 55
    assert [s.rid for s in r.spans] == [6, 7, 8, 9]


def test_a_mapped_span_meets_a_profiler_range_opened_with_it():
    """The median over nine ranges, so that one range delayed by a busy host
    does not decide it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    r = obs.Recorder()
    starts = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(9):
            r.anchor()
            t = obs.now()
            with record_function(f"test.range{i}"):
                torch.ones(8).sum()
            r.record("test.span", t, obs.now())
            starts.append(t)
    events = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("test.range")}
    offsets = [events[f"test.range{i}"] - r.to_profiler_ns(t) for i, t in enumerate(starts)]
    assert abs(np.median(offsets)) < 1_000_000


def test_spans_map_through_the_newest_anchor_before_them():
    r = obs.Recorder()
    r._anchors.extend([(100, 5_000), (200, 7_000)])
    assert r.to_profiler_ns(50) == 5_050        # before every anchor: the oldest
    assert r.to_profiler_ns(150) == 5_150
    assert r.to_profiler_ns(200) == 7_200
    assert r.to_profiler_ns(10**6) == 10**6 + 7_000


def test_chrome_events_are_well_formed(rec):
    engine = _engine()
    _serve(engine)
    events = rec.chrome_events()
    assert len(events) == len(rec.spans)
    json.dumps(events)
    for e, s in zip(events, rec.spans):
        assert e["ph"] == "X" and e["name"] == s.name
        assert e["dur"] == pytest.approx((s.end - s.start) / 1e3) and e["dur"] >= 0
        assert e["ts"] == pytest.approx(rec.to_profiler_ns(s.start) / 1e3)
        assert isinstance(e["pid"], int) and e["tid"] == (0 if s.rid is None else s.rid + 1)
        assert e["args"]["id"] == s.id and e["args"]["parent"] == s.parent
        assert e["args"]["rid"] == s.rid


def test_launcher_prints_the_summary_and_writes_the_trace(capsys, tmp_path, rec):
    out = tmp_path / "spans.json"
    done = launch_serve.main(["--device", "cpu", "--requests", "5", "--max-batch", "2",
                              "--max-len", "32", "--max-new", "4", "--trace-out", str(out)])
    assert len(done) == 5
    text = capsys.readouterr().out
    assert "requests 5; queue wait p50" in text and "per 1,000 prompt tokens" in text
    assert "decode step" in text and "at a step's start" in text
    assert "slot efficiency" in text
    events = json.loads(out.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert names == {"serve.step", "serve.decode", *REQUEST_SPANS}
    assert sum(e["name"] == "serve.request.queued" for e in events) == 5
