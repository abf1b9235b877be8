"""The port's kernel build under threads, on the CPU with a stub compiler:
runner threads of one process may launch a kernel for the first time
together, so concurrent builds of one source must compile it once and load
one whole library, and each kernel module's lazy ``_library()`` must build
and bind once (the decode kernel's once per dtype and head_dim, each its own
library, selected by ``-D`` flags)."""

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import _ctypes
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as decode_module  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_module  # noqa: E402
from repro_torch.kernels.rglru import kernel as lru_module  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_module  # noqa: E402

THREADS = 16            # more than this machine's cores
WAIT_S = 60.0

# Stands in for nvcc: logs its output path, then writes a real shared object
# (a copy of the _ctypes extension, which ctypes can load) in two halves with
# a pause between, so a reader that does not wait sees half a file.
_STUB = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(out + "\\n")
data = open({so!r}, "rb").read()
with open(out, "wb") as f:
    f.write(data[:len(data) // 2])
    f.flush()
    time.sleep(0.2)
    f.write(data[len(data) // 2:])
print("ptxas info    : stub")
"""


def _together(fn, n=THREADS):
    """Run ``fn`` in ``n`` threads released at once; return their results."""
    barrier = threading.Barrier(n)

    def job():
        barrier.wait(WAIT_S)
        return fn()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(n) as pool:
            futures = [pool.submit(job) for _ in range(n)]
            return [f.result(timeout=WAIT_S) for f in futures]
    finally:
        sys.setswitchinterval(old)


def test_concurrent_builds_of_one_source_compile_once(tmp_path, monkeypatch):
    log = tmp_path / "calls.log"
    stub = tmp_path / "nvcc"
    stub.write_text(_STUB.format(python=sys.executable, log=str(log), so=_ctypes.__file__))
    stub.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(stub))
    source = tmp_path / "kernel.cu"
    source.write_text("// a source the stub never reads\n")
    out = tmp_path / "build"
    libs = _together(lambda: build.build_library(source, out))
    assert len(log.read_text().splitlines()) == 1          # compiled once
    built = sorted(p.name for p in out.iterdir())
    assert [n for n in built if n.endswith(".so")] == [libs[0]._name.rsplit("/", 1)[1]]
    assert not [n for n in built if n.endswith(".tmp")]
    assert {lib._name for lib in libs} == {libs[0]._name}


@pytest.mark.parametrize("module", [flash_module, ssd_module, lru_module],
                         ids=["flash_attention", "ssd", "rglru"])
def test_lazy_library_is_built_and_bound_once_across_threads(monkeypatch, module):
    calls = []

    def slow_build(source):
        calls.append(source)
        time.sleep(0.2)
        return mock.MagicMock()

    monkeypatch.setattr(module, "build_library", slow_build)
    monkeypatch.setattr(module, "_lib", None)
    libs = _together(module._library)
    assert calls == [module.SOURCE]
    assert all(lib is libs[0] for lib in libs)


def test_defines_select_their_own_library(tmp_path, monkeypatch):
    """``defines`` reach nvcc and are hashed into the library's name: two
    selections of one source are two libraries, each compiled once."""
    log = tmp_path / "calls.log"
    stub = tmp_path / "nvcc"
    stub.write_text(_STUB.format(python=sys.executable, log=str(log), so=_ctypes.__file__)
                    .replace("f.write(out + ", "f.write(' '.join(sys.argv) + "))
    stub.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(stub))
    source = tmp_path / "kernel.cu"
    source.write_text("// a source the stub never reads\n")
    out = tmp_path / "build"
    plain = build.build_library(source, out)
    a = build.build_library(source, out, defines=("-DX=1",))
    b = build.build_library(source, out, defines=("-DX=2",))
    assert build.build_library(source, out, defines=("-DX=1",))._name == a._name
    assert len({plain._name, a._name, b._name}) == 3
    calls = log.read_text().splitlines()
    assert len(calls) == 3 and ["-DX=1" in c for c in calls] == [False, True, False]
    assert "-DX=2" in calls[2]


def test_decode_library_is_built_once_per_dtype_and_head_dim(monkeypatch):
    calls = []

    def slow_build(source, defines=()):
        calls.append((source, defines))
        time.sleep(0.2)
        return mock.MagicMock()

    monkeypatch.setattr(decode_module, "build_library", slow_build)
    monkeypatch.setattr(decode_module, "_libs", {})
    monkeypatch.setattr(decode_module, "_locks", {})
    keys = [(torch.bfloat16, 128), (torch.float32, 16)]
    libs = _together(lambda: [decode_module._library(*k) for k in keys])
    assert sorted(calls) == sorted([
        (decode_module.SOURCE, ("-DREPRO_DECODE_BF16=1", "-DREPRO_DECODE_D=128")),
        (decode_module.SOURCE, ("-DREPRO_DECODE_BF16=0", "-DREPRO_DECODE_D=16"))])
    assert all(pair[0] is libs[0][0] and pair[1] is libs[0][1] for pair in libs)
    assert libs[0][0] is not libs[0][1]
