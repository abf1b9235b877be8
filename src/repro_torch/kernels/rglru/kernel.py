"""Binding of the hand-written CUDA RG-LRU scan kernel
(``src/repro_torch/csrc/lru_scan.cu``), which replaces the reference's
Pallas kernel ``kernels/rglru/kernel.py::lru_scan_kernel``.

The library is built with ``nvcc`` at the first launch (see
:mod:`repro_torch.kernels.build`); importing this module builds nothing, so
the CPU tests import it freely. :func:`lru_scan_kernel` takes CUDA tensors
only: it launches the kernel or raises, and never falls back.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library

__all__ = ["lru_scan_kernel", "SOURCE"]

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "lru_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build_library(SOURCE)
        fn = lib.repro_lru_scan
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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
    from h_0 = 0 with an f32 carry."""
    _check(a, b)
    B, S, W = a.shape
    out = torch.empty_like(a)
    fn = _library().repro_lru_scan
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, S, W,
                 _DTYPES[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"lru_scan kernel launch failed: CUDA error {err}")
    lru_scan_kernel.launches += 1
    return out


lru_scan_kernel.launches = 0
