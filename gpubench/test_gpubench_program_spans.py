"""CPU tests of the per-layer metrics that read the serving engine's own
spans (``repro_torch.obs``; ``gpubench/engine_spans.py``): each on a
synthetic run, recorder and profiler trace gives its value by hand, and
nothing where there is nothing sound to read (no spans, spans dropped after
the window opened, no trace, a port without the recorder)."""

from __future__ import annotations

import sys

import pytest
from torch.autograd import DeviceType

import repro_torch
from gpubench.bench import Bench, Run
from gpubench.timeline import Trace
from repro_torch import obs

BENCH = Bench()
METRICS = ["admit_wait_p90_ms.serve", "first_token_hold_p90_ms.serve",
           "engine_prefill_ms_per_ktok.serve", "engine_decode_step_ms.batch",
           "decode_idle_ms.batch", "prefill_idle_share.serve"]
W0, CLOSED, TRACED = 100.0, 108.5, 106.0     # the window opens, closes; the profiler starts


class _Ev:
    def __init__(self, name, start, dur, device=False):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def correlation_id(self):
        return 0

    def linked_correlation_id(self):
        return 0


def _ns(t: float) -> int:
    return round(t * 1e9)


def _request_spans(rec, rid, submit, queued, prefill, hold, tokens=1000):
    """A request's three spans, in s; its step is one of its own."""
    a, b, c = submit + queued, submit + queued + prefill, submit + queued + prefill + hold
    step = rec.new_id()
    rec.record("serve.request.queued", _ns(submit), _ns(a), parent=step, rid=rid)
    rec.record("serve.request.prefill", _ns(a), _ns(b), parent=step, rid=rid, tokens=tokens)
    rec.record("serve.request.hold", _ns(b), _ns(c), parent=step, rid=rid)
    rec.record("serve.step", _ns(a), _ns(c), span_id=step, index=0, queue=0, active=0,
               admitted=1)


def _requests(rec):
    """Harness records and engine spans: five admitted requests due before
    the traced part (queued 10-50 ms, prefill 20-100 ms of 1,000 tokens, hold
    100-500 ms), one due then and never admitted, one due in the traced part
    (left out) and one before the window (left out)."""
    reqs = []
    for i in range(5):
        due = W0 + 1.0 + i
        reqs.append({"rid": i, "due": due, "submit": due + 0.001})
        _request_spans(rec, i, due + 0.001, 0.01 * (i + 1), 0.02 * (i + 1), 0.1 * (i + 1))
    reqs.append({"rid": 5, "due": 105.0, "submit": 105.5})                 # never admitted
    reqs.append({"rid": 6, "due": 106.5, "submit": 106.5})
    _request_spans(rec, 6, 106.5, 1.0, 1.0, 1.0)
    reqs.append({"rid": 7, "due": 99.0, "submit": 99.0})
    _request_spans(rec, 7, 99.0, 0.5, 0.5, 5.0)
    return reqs


def _decodes(rec):
    """Decode spans of 250 and 260 ms before the traced part, one of 900 ms
    in it (106.5-107.4), and one before the window."""
    for a, b in ((101.0, 101.25), (102.0, 102.26), (106.5, 107.4), (99.0, 99.5)):
        rec.record("serve.decode", _ns(a), _ns(b), active=64, contexts=1000)


def _trace(rec):
    """The traced part, 106.0-108.4 s mapped onto the profiler's clock,
    busy 106.0-106.3, 106.35-106.6 and 107.0-108.4: idle 106.3-106.35 and
    106.6-107.0."""
    def p(t):
        return rec.to_profiler_ns(_ns(t))
    events = [_Ev("gpubench.window", p(106.0), p(108.4) - p(106.0))]
    events += [_Ev("kernel", p(a), p(b) - p(a), device=True)
               for a, b in ((106.0, 106.3), (106.35, 106.6), (107.0, 108.4))]
    return Trace(events, window="gpubench.window")


def _run(cell, rec, requests=(), trace=True):
    run = Run(cell, {}, {}, 0, 8.0, True)
    run.window, run.requests = (W0, CLOSED), list(requests)
    run.extra["traced"] = [TRACED, 108.4]
    run.trace = _trace(rec) if trace else None
    return run


@pytest.fixture
def rec(monkeypatch):
    r = obs.Recorder()
    r.anchor()
    monkeypatch.setattr(obs, "RECORDER", r)
    return r


def _read(name, run):
    return BENCH.reader(name).read(run)


def test_admit_wait_counts_unadmitted_requests_to_the_close(rec):
    run = _run("granite-8b.serve.longprompt", rec, _requests(rec))
    # six due before the traced part: 10-50 ms queued, and 108.5 - 105.5 s
    assert _read("admit_wait_p90_ms.serve", run) == pytest.approx(3000.0)
    run.requests = run.requests[:5]
    assert _read("admit_wait_p90_ms.serve", run) == pytest.approx(50.0)
    run.extra["traced"] = [103.5, 108.4]             # three due before the profiler started
    assert _read("admit_wait_p90_ms.serve", run) == pytest.approx(30.0)


def test_first_token_hold_is_over_the_admitted_requests_due_before_the_trace(rec):
    run = _run("granite-8b.serve.longprompt", rec, _requests(rec))
    # holds of 100-500 ms; the unadmitted request has none
    assert _read("first_token_hold_p90_ms.serve", run) == pytest.approx(500.0)
    run.extra["traced"] = [104.5, 108.4]
    assert _read("first_token_hold_p90_ms.serve", run) == pytest.approx(400.0)


def test_engine_prefill_is_per_1000_prompt_tokens_before_the_trace(rec):
    run = _run("granite-8b.serve.longprompt", rec, _requests(rec))
    # 20 + 40 + 60 + 80 + 100 ms over 5,000 tokens; the spans at 99.5 and 107.5 s left out
    assert _read("engine_prefill_ms_per_ktok.serve", run) == pytest.approx(60.0)


def test_engine_decode_step_is_the_mean_before_the_trace(rec):
    _decodes(rec)
    run = _run("granite-8b.batch.decode", rec)
    assert _read("engine_decode_step_ms.batch", run) == pytest.approx(255.0)


def test_decode_idle_is_the_idle_time_inside_mapped_decode_spans(rec):
    _decodes(rec)
    rec.record("serve.decode", _ns(106.2), _ns(106.4))
    run = _run("granite-8b.batch.decode", rec)
    # 106.2-106.4 holds 50 ms of idle, 106.5-107.4 holds 400 ms
    assert _read("decode_idle_ms.batch", run) == pytest.approx(225.0)


def test_prefill_idle_share_is_over_the_mapped_prefill_spans(rec):
    rec.record("serve.request.prefill", _ns(106.2), _ns(106.5), tokens=10)
    rec.record("serve.request.prefill", _ns(106.9), _ns(107.1), tokens=10)
    rec.record("serve.request.prefill", _ns(105.0), _ns(105.9), tokens=10)   # before the trace
    run = _run("granite-8b.serve.longprompt", rec)
    # 50 ms idle of 300, 100 ms of 200
    assert _read("prefill_idle_share.serve", run) == pytest.approx(30.0)


def _full(rec):
    reqs = _requests(rec)
    _decodes(rec)
    return reqs


def test_nothing_is_read_without_spans(rec):
    for name in METRICS:
        assert _read(name, _run("granite-8b.serve.longprompt", rec)) is None, name


def test_nothing_is_read_when_spans_ending_in_the_window_were_dropped(rec, monkeypatch):
    reqs = _full(rec)
    small = obs.Recorder(capacity=len(rec.spans) - 1)
    small._anchors = rec._anchors
    for s in rec.spans:
        small.record(s.name, s.start, s.end, parent=s.parent, rid=s.rid, span_id=s.id,
                     **s.attrs)
    assert small.dropped == 1 and small.dropped_end > _ns(W0)
    monkeypatch.setattr(obs, "RECORDER", small)
    for name in METRICS:
        assert _read(name, _run("granite-8b.serve.longprompt", rec, reqs)) is None, name


def test_spans_dropped_before_the_window_leave_it_whole(rec, monkeypatch):
    reqs = _full(rec)
    small = obs.Recorder(capacity=len(rec.spans))
    small._anchors = rec._anchors
    small.record("serve.decode", _ns(10.0), _ns(11.0))      # dropped: ended long before
    for s in rec.spans:
        small.record(s.name, s.start, s.end, parent=s.parent, rid=s.rid, span_id=s.id,
                     **s.attrs)
    assert small.dropped == 1
    monkeypatch.setattr(obs, "RECORDER", small)
    run = _run("granite-8b.serve.longprompt", rec, reqs)
    assert _read("admit_wait_p90_ms.serve", run) == pytest.approx(3000.0)
    assert _read("engine_decode_step_ms.batch", run) == pytest.approx(255.0)


def test_idle_metrics_need_a_trace(rec):
    reqs = _full(rec)
    run = _run("granite-8b.serve.longprompt", rec, reqs, trace=False)
    assert _read("decode_idle_ms.batch", run) is None
    assert _read("prefill_idle_share.serve", run) is None
    assert _read("engine_decode_step_ms.batch", run) == pytest.approx(255.0)


def test_a_port_without_the_recorder_reads_nothing(rec, monkeypatch):
    reqs = _full(rec)
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    for name in METRICS:
        assert _read(name, _run("granite-8b.serve.longprompt", rec, reqs)) is None, name


def _probe_trace(rec):
    """``_trace``'s busy and idle time, with the harness's decode range
    opening 100 us after the engine's decode span (106.5 s)."""
    def p(t):
        return rec.to_profiler_ns(_ns(t))
    events = [_Ev("gpubench.window", p(106.0), p(108.4) - p(106.0)),
              _Ev("gpubench.decode", p(106.5001), p(107.39) - p(106.5001))]
    events += [_Ev("kernel", p(a), p(b) - p(a), device=True)
               for a, b in ((106.0, 106.3), (106.35, 106.6), (107.0, 108.4))]
    return Trace(events, ranges=("gpubench.decode",), window="gpubench.window")


def test_the_probe_splits_idle_time_and_the_ttft_by_engine_span(rec):
    from gpubench import engine_probe
    reqs = _requests(rec)
    hold = {s.rid: s for s in rec.spans if s.name == "serve.request.hold"}
    for r in reqs:                      # the first token at the step's return
        r["times"] = [hold[r["rid"]].end / 1e9] if r["rid"] in hold else []
    step = rec.new_id()                 # a step of the traced part: 106.31-107.45
    rec.record("serve.request.prefill", _ns(106.32), _ns(106.4), parent=step, tokens=10)
    rec.record("serve.decode", _ns(106.5), _ns(107.4), parent=step)
    rec.record("serve.step", _ns(106.31), _ns(107.45), span_id=step)
    run = _run("granite-8b.serve.longprompt", rec, reqs)
    run.trace = _probe_trace(rec)
    out = engine_probe.analyse(BENCH, run, rec)
    assert out["metrics"]["admit_wait_p90_ms.serve"] == pytest.approx(3000.0)
    # idle 106.3-106.35 and 106.6-107.0: 30 ms in the prefill, 400 in the decode,
    # 10 in the rest of the step and 10 outside it (rid 6's step holds none)
    split = out["idle_split"]
    assert split["idle_s"] == pytest.approx(0.45)
    assert split["prefill_s"] == pytest.approx(0.03)
    assert split["decode_s"] == pytest.approx(0.4)
    assert split["rest_of_step_s"] == pytest.approx(0.01)
    assert split["outside_steps_s"] == pytest.approx(0.01)
    assert out["agree"]["serve.decode"]["n"] == 1
    assert out["agree"]["serve.decode"]["us"] == pytest.approx([100.0] * 3, abs=1e-3)
    assert out["agree"]["serve.request.prefill"] == {"n": 0, "us": None}
    # five requests due before the traced part with a first token: 1 ms late,
    # queued 10-50, prefill 20-100, hold 100-500 ms
    ttft = out["ttft"]
    assert ttft["n"] == 5 and ttft["of"] == 7 and ttft["over_1ms"] == 0
    assert ttft["late"] == pytest.approx([1.0, 1.0])
    assert ttft["queued"] == pytest.approx([30.0, 50.0])
    assert ttft["prefill"] == pytest.approx([60.0, 100.0])
    assert ttft["hold"] == pytest.approx([300.0, 500.0])
    assert ttft["ttft"] == pytest.approx([391.0, 651.0])
    assert ttft["sum_minus_ttft_ms"] == pytest.approx([0.0, 0.0], abs=1e-6)


def test_the_probe_times_the_recorder_and_maps_profiler_events():
    from gpubench import engine_probe
    out = engine_probe.cost(n=1000)
    assert out["record_ns"] > 0 and out["step_with_one_admission_ns"] > out["record_ns"]
    lo, mid, hi = out["profiler_event_minus_mapped_us"]
    assert lo <= mid <= hi and abs(mid) < 1000
