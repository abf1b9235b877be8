"""The port's kernel build under threads, on the CPU with a stub compiler:
runner threads of one process may launch a kernel for the first time
together, so concurrent builds of one source must compile it once and load
one whole library, and each kernel module's lazy ``_library()`` must build
and bind once."""

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import _ctypes
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.kernels import build  # noqa: E402
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
