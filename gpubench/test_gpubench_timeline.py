"""CPU tests of the trace reduction (gpubench.timeline) on synthetic
profiler events: the window, the busy union, idle gaps by host span, and
device time attributed to an op's range by its launches."""

from __future__ import annotations

import pytest
from torch.autograd import DeviceType

from gpubench.timeline import Trace, merge


class _Ev:
    def __init__(self, name, start, dur, device=False, corr=0, linked=0):
        self._n, self._s, self._d, self._dev = name, start, dur, device
        self._c, self._l = corr, linked

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def _events():
    return [
        _Ev("gpubench.window", 100, 1000),
        _Ev("gpubench.window", 100, 1000, device=True),         # its range on the device
        _Ev("gpubench.step", 100, 500),
        _Ev("repro_torch::flash_attention", 150, 100),           # the op, twice nested
        _Ev("repro_torch::flash_attention", 160, 80),
        _Ev("cudaLaunchKernel", 170, 5, corr=7),
        _Ev("flash_fwd_kernel", 200, 300, device=True, linked=7),
        _Ev("cudaLaunchKernel", 300, 5, corr=8),
        _Ev("gemm", 450, 250, device=True, linked=8),            # overlaps the flash kernel
        _Ev("cudaLaunchKernel", 20, 5, corr=9),
        _Ev("gemm", 40, 100, device=True, linked=9),             # straddles the window's start
        _Ev("repro_torch::flash_attention", 30, 10),             # before the window: left out
        _Ev("copy", 1050, 200, device=True),                     # straddles its end
    ]


def test_window_busy_and_ops_are_clipped_to_the_window():
    t = Trace(_events(), ranges=("gpubench.step", "repro_torch::flash_attention"),
              window="gpubench.window")
    assert t.window == (100, 1100) and t.window_s == pytest.approx(1e-6)
    # busy: [100, 140] + [200, 700] + [1050, 1100]
    assert t.busy == [(100, 140), (200, 700), (1050, 1100)]
    assert t.busy_s == pytest.approx(590e-9)
    assert t.ops == {"gemm": [2, 290], "flash_fwd_kernel": [1, 300], "copy": [1, 50]}
    assert t.top_ops(2) == [["flash_fwd_kernel", 300e-9], ["gemm", 290e-9]]
    assert "gpubench.window" not in t.ops


def test_an_op_owns_the_kernels_launched_inside_it_once():
    t = Trace(_events(), ranges=("repro_torch::flash_attention",), window="gpubench.window")
    r = t.ranges["repro_torch::flash_attention"]
    assert r["calls"] == 1 and r["device_ns"] == 300


def test_idle_gaps_are_named_by_the_innermost_host_span():
    t = Trace(_events(), ranges=("gpubench.step",), window="gpubench.window")
    assert t.idle_gaps() == [(140, 200), (700, 1050)]
    got = dict(t.idle_by(("gpubench.window", "gpubench.step")))
    assert got == pytest.approx({"gpubench.step": 60e-9, "gpubench.window": 350e-9})


def test_merge_joins_nested_and_overlapping_intervals():
    assert merge([(5, 6), (1, 4), (2, 3), (4, 5)]) == [(1, 6)]
    assert merge([(1, 2), (3, 4)]) == [(1, 2), (3, 4)]
