"""Build a CUDA source of the port into a shared library and load it.

Kernels have a plain C interface and are bound with ``ctypes``: ``nvcc``
compiles one ``.cu`` file in seconds, where an extension that includes
PyTorch's headers takes minutes. The library is built at first use, from
the repository's sources only, into ``src/repro_torch/_build/`` (listed in
``.gitignore``). Its file name carries a hash of the source, the headers
beside it (``csrc/*.cuh``) and the flags, so an edited source is rebuilt and
never confused with a stale library. Builds of one library are serialised
within a process (runner threads may launch a kernel first at the same
time), and the temporary file carries the process id, so two processes
never write one file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_library"]

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_locks: dict[Path, threading.Lock] = {}      # one per library file
_locks_guard = threading.Lock()


def _nvcc() -> str:
    for candidate in (shutil.which("nvcc"),
                      os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                   "bin", "nvcc")):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels are built from source on the card's host")


def build_library(source: Path, build_dir: Path = BUILD_DIR,
                  defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile ``source`` with ``nvcc`` (once per source hash) into
    ``build_dir`` and load it. ``defines`` (``-D`` flags) select a part of
    the source to compile; they are hashed with the flags, so each
    selection is its own library.

    The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``<name>.log``."""
    source, build_dir = Path(source), Path(build_dir)
    flags = (*NVCC_FLAGS, *defines)
    headers = b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()[:16]
    lib = build_dir / f"lib{source.stem}-{digest}.so"
    with _locks_guard:
        lock = _locks.setdefault(lib, threading.Lock())
    with lock:
        if not lib.exists():
            build_dir.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(source)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source.name} "
                                   f"(exit {proc.returncode}):\n{proc.stderr}")
            lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib)   # atomic: other processes never see half a file
    return ctypes.CDLL(str(lib))
