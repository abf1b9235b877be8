"""Binding of the hand-written CUDA flash-attention kernel
(``src/repro_torch/csrc/flash_attention.cu``), which replaces the reference's
Pallas kernel ``kernels/flash_attention/kernel.py::flash_attention_kernel``.

The library is built with ``nvcc`` at the first launch (see
:mod:`repro_torch.kernels.build`); importing this module builds nothing, so
the CPU tests import it freely. :func:`flash_attention_kernel` takes CUDA
tensors only: it launches the kernel or raises, and never falls back.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library

__all__ = ["flash_attention_kernel", "SOURCE", "HEAD_DIMS"]

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "flash_attention.cu"
HEAD_DIMS = (8, 16, 32, 64, 128, 256)       # 8 runs at width 16, zero-filled
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_lock = threading.Lock()     # guards _lib and the launch count: threads launch too


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_library(SOURCE)
        fn = lib.repro_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, q has {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, S, heads, D), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported; use float32 or bfloat16")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    Sk, K = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported; have {HEAD_DIMS}")
    if Sq < 1 or Sk < 1 or K < 1 or H % K:
        raise ValueError(f"bad shapes: Sq={Sq} Sk={Sk} H={H} K={K}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = True, window: int | None = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, K, D), contiguous CUDA tensors of one
    dtype (float32 or bfloat16). Returns (B, Sq, H, D) in q's dtype; the
    scores are scaled by D^-0.5."""
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _library().repro_flash_attention_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, H, K, D, _DTYPES[q.dtype], int(causal),
                 0 if window is None else int(window), D ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    with _lock:
        flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
