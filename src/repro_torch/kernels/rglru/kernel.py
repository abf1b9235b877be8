"""Binding of the hand-written CUDA RG-LRU scan
(``src/repro_torch/csrc/lru_scan.cu``), which replaces the reference's
Pallas kernel ``kernels/rglru/kernel.py::lru_scan_kernel``.

The scan is chunked: S is cut into chunks of L steps, and one call launches
three kernels (chunk summaries, the carry across chunks, the re-walk of each
chunk from its carry-in). The wrapper asks the library for L
(``repro_lru_scan_chunk_len``, which alone knows the launch geometry) and
allocates the f32 scratch the kernels share; the library reports the grid
it launched, which :data:`lru_scan_kernel.last_launch` keeps.

The library is built with ``nvcc`` at the first launch (see
:mod:`repro_torch.kernels.build`); importing this module builds nothing, so
the CPU tests import it freely. :func:`lru_scan_kernel` takes CUDA tensors
only: it launches the kernel or raises, and never falls back.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library

__all__ = ["lru_scan_kernel", "SOURCE"]

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "lru_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID = (ctypes.c_longlong * 4)()    # the library's report of the last launch

_lib = None
_lock = threading.Lock()     # guards _lib and the launch count: threads launch too


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_library(SOURCE)
        lib.repro_lru_scan_chunk_len.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        lib.repro_lru_scan_chunk_len.restype = ctypes.c_int
        fn = lib.repro_lru_scan
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                       + [ctypes.POINTER(ctypes.c_longlong)])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name} must be on a's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"a and b must share a dtype in {list(_DTYPES)}, got "
                         f"{a.dtype} and {b.dtype}")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must both "
                         "be (B, S, W)")
    if min(a.shape) < 1:
        raise ValueError(f"empty shape {tuple(a.shape)}")


def lru_scan_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W), contiguous CUDA tensors of one dtype (float32 or
    bfloat16). Returns h: (B, S, W) in that dtype, h_t = a_t h_{t-1} + b_t
    from h_0 = 0 with an f32 carry.

    One call launches up to three kernels and counts one launch in
    ``lru_scan_kernel.launches`` (a scan, not a kernel: recurrentgemma-2b's
    prefill counts one per rglru layer). ``lru_scan_kernel.last_launch`` is
    the last call's (L, V, chunk-pass CTAs, carry-pass CTAs, apply-pass
    CTAs), V being the channels a thread (1 on the scalar route), as the
    library launched them."""
    _check(a, b)
    B, S, W = a.shape
    is_bf16 = _DTYPES[a.dtype]
    out = torch.empty_like(a)
    lib = _library()
    with torch.cuda.device(a.device):
        L = lib.repro_lru_scan_chunk_len(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                         B, S, W, is_bf16)
        if L < 1:
            raise RuntimeError(f"lru_scan chunk length query failed: CUDA error {-L}")
        # chunk summaries A and H, then each chunk's carry-in
        n = B * -(-S // L) * W
        scratch = torch.empty(3 * n, dtype=torch.float32, device=a.device)
        p = scratch.data_ptr()
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.repro_lru_scan(a.data_ptr(), b.data_ptr(), out.data_ptr(), p, p + 4 * n,
                                 p + 8 * n, B, S, W, L, is_bf16, stream, _GRID)
    if err != 0:
        raise RuntimeError(f"lru_scan kernel launch failed: CUDA error {err}")
    with _lock:
        lru_scan_kernel.launches += 1
    lru_scan_kernel.last_launch = (L, *_GRID)
    return out


lru_scan_kernel.launches = 0
lru_scan_kernel.last_launch = None
