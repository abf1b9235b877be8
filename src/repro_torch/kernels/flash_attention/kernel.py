"""Bindings of the hand-written CUDA flash-attention kernels:
``src/repro_torch/csrc/flash_attention.cu``, the forward, which replaces the
reference's Pallas kernel
``kernels/flash_attention/kernel.py::flash_attention_kernel``; and
``src/repro_torch/csrc/flash_attention_bwd.cu``, its gradient (dQ, dK, dV
by recomputing P tile by tile), the card's form of the gradient of the
reference's chunked attention (``attn_chunked``).

Each library is built with ``nvcc`` at its first launch (see
:mod:`repro_torch.kernels.build`); importing this module builds nothing, so
the CPU tests import it freely. :func:`flash_attention_kernel` and
:func:`flash_attention_bwd_kernel` take CUDA tensors only: each launches
its kernel or raises, and never falls back.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library

__all__ = ["flash_attention_kernel", "flash_attention_bwd_kernel", "bind_bwd", "SOURCE",
           "SOURCE_BWD", "HEAD_DIMS"]

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "flash_attention.cu"
SOURCE_BWD = SOURCE.with_name("flash_attention_bwd.cu")
HEAD_DIMS = (8, 16, 32, 64, 128, 256)       # 8 runs at width 16, zero-filled
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_bwd_lib = None
_lock = threading.Lock()     # guards the libraries and the launch counts: threads launch too


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


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and return types of a backward library's C
    functions (``SOURCE_BWD``'s, or a build of a variant of it)."""
    fn = lib.repro_flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_flash_attention_bwd_scratch_floats.argtypes = [ctypes.c_int] * 7
    lib.repro_flash_attention_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.repro_flash_attention_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.repro_flash_attention_bwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def _bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    with _lock:
        if _bwd_lib is None:
            _bwd_lib = bind_bwd(build_library(SOURCE_BWD))
    return _bwd_lib


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


def flash_attention_bwd_kernel(grad_o: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor, *, causal: bool = True,
                               window: int | None = None):
    """The gradient of :func:`flash_attention_kernel`'s attention at (q, k,
    v), whose output was ``o``, with cotangent ``grad_o``: (dq, dk, dv) in
    the inputs' dtype, the same masks and GQA, scale D^-0.5. q, o, grad_o:
    (B, Sq, H, D); k, v: (B, Sk, K, D); contiguous CUDA tensors of one dtype
    (float32 or bfloat16). Three kernels a call (the rows' log-sum-exp and
    rowsum(dO o O), then dK and dV, then dQ), and a fourth that sums the q
    heads' dK and dV where the library splits the dK/dV pass over them;
    ``launches`` counts calls."""
    _check(q, k, v, window)
    for name, t in (("grad_o", grad_o), ("o", o)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} must match q: {t.device} {t.dtype} {tuple(t.shape)} "
                             f"against {q.device} {q.dtype} {tuple(q.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if H > 65535 or B > 65535:
        raise ValueError(f"H={H} and B={B} must be at most 65535 (the grid's y and z)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        # the rows' L, then the dK/dV pass's per-head f32 partials where the
        # library's split rule (on this device's SM count) splits it
        lse = torch.empty(lib.repro_flash_attention_bwd_scratch_floats(
            B, Sq, Sk, H, K, D, _DTYPES[q.dtype]), dtype=torch.float32, device=q.device)
        delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_bwd(
            grad_o.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            B, Sq, Sk, H, K, D, _DTYPES[q.dtype], int(causal),
            0 if window is None else int(window), D ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: CUDA error {err}")
    with _lock:
        flash_attention_bwd_kernel.launches += 1
    return dq, dk, dv


flash_attention_bwd_kernel.launches = 0
