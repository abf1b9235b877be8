"""Binding of the hand-written CUDA SSD chunked-scan kernel
(``src/repro_torch/csrc/ssd_scan.cu``), which replaces the reference's
Pallas kernel ``kernels/ssd/kernel.py::ssd_kernel``.

The library is built with ``nvcc`` at the first launch (see
:mod:`repro_torch.kernels.build`); importing this module builds nothing, so
the CPU tests import it freely. :func:`ssd_kernel` takes CUDA tensors only:
it launches the kernel or raises, and never falls back.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library

__all__ = ["ssd_kernel", "SOURCE"]

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "ssd_scan.cu"
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_SMEM = 232448               # the H100's opt-in shared memory per block
TC_MAX_P, TC_MAX_N = 64, 128     # the bf16 route's register tiles

_lib = None
_lock = threading.Lock()     # guards _lib and the launch count: threads launch too


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_library(SOURCE)
        fn = lib.repro_ssd_fwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.repro_ssd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.repro_ssd_smem_bytes.restype = ctypes.c_longlong
        fn = lib.repro_ssd_fwd_bf16
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, dt, A, Bm, Cm) -> None:
    named = (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm))
    for name, t in named:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be on x's CUDA device, got {t.device}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x, Bm and Cm must share a dtype in {list(_DTYPES)}, got "
                         f"{x.dtype}, {Bm.dtype} and {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32, got {dt.dtype} and {A.dtype}")
    if x.dim() != 4 or min(x.shape) < 1:
        raise ValueError(f"x must be a non-empty (B, S, H, P), got {tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    if (dt.shape != (Bsz, S, H) or A.shape != (H,) or Bm.dim() != 3
            or Bm.shape[:2] != (Bsz, S) or Cm.shape != Bm.shape or Bm.shape[2] < 1):
        raise ValueError(f"shapes do not match x {tuple(x.shape)}: dt {tuple(dt.shape)} "
                         f"(B,S,H), A {tuple(A.shape)} (H,), Bm {tuple(Bm.shape)} and "
                         f"Cm {tuple(Cm.shape)} (B,S,N)")
    if not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("dt and A must be contiguous")
    # x, Bm and Cm may be views (strided over batch and step) of one projection
    if x.stride(3) != 1 or x.stride(2) != P or Bm.stride(2) != 1 or Cm.stride(2) != 1:
        raise ValueError(f"x (strides {x.stride()}) must be packed over (H, P) and "
                         f"Bm, Cm (strides {Bm.stride()}, {Cm.stride()}) over N")


def _check_tensor_core_route(x, Bm, Cm) -> None:
    """What the bf16 route's tiles and 16-byte cp.async copies need."""
    P, N = x.shape[3], Bm.shape[2]
    if P > TC_MAX_P or N > TC_MAX_N or P % 8 or N % 8:
        raise ValueError(f"the bf16 SSD kernel takes P <= {TC_MAX_P} and N <= {TC_MAX_N}, "
                         f"both multiples of 8; got P={P}, N={N}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8:
            raise ValueError(f"{name} must start 16-byte aligned with batch and step "
                             f"strides that are multiples of 8 elements, got strides "
                             f"{t.stride()}")


def ssd_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, *, chunk: int = 256) -> torch.Tensor:
    """x: (B,S,H,P); dt: (B,S,H) f32; A: (H,) f32; Bm, Cm: (B,S,N), CUDA
    tensors; x, Bm and Cm of one dtype (float32 or bfloat16), packed after
    their step dim (views of one projection are read in place); dt and A
    contiguous. Returns
    y: (B,S,H,P) in x's dtype, the SSD scan from a zero state over chunks of
    min(chunk, S) steps. bfloat16 runs the chunk-parallel tensor-core
    kernels, float32 the two-pass FMA kernel."""
    _check(x, dt, A, Bm, Cm)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[2]
    Q = min(chunk, S)
    lib = _library()
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    strides = (ctypes.c_longlong * 6)(x.stride(0), x.stride(1), Bm.stride(0),
                                      Bm.stride(1), Cm.stride(0), Cm.stride(1))
    nc = -(-S // Q)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dtype == torch.bfloat16:
            _check_tensor_core_route(x, Bm, Cm)
            # cum in dt's layout; the per-chunk states, which the state pass
            # turns into the state at the start of every chunk but the first,
            # written as its two-term bf16 split
            cum = torch.empty((Bsz, S, H), dtype=torch.float32, device=x.device)
            states = torch.empty((Bsz, nc - 1, H, P, N), dtype=torch.float32,
                                 device=x.device)
            hsplit = torch.empty((Bsz, nc - 1, H, 2, P, N), dtype=torch.bfloat16,
                                 device=x.device)
            err = lib.repro_ssd_fwd_bf16(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                                         Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                                         cum.data_ptr(), states.data_ptr(),
                                         hsplit.data_ptr(), Bsz, S, H, P, N, Q, strides,
                                         stream)
        else:
            smem = lib.repro_ssd_smem_bytes(Q, N)
            if smem > _MAX_SMEM:
                raise ValueError(f"chunk {Q} x state {N} needs {smem} bytes of shared "
                                 f"memory per block, above the card's {_MAX_SMEM}")
            # the first pass's C B^T tiles, one Q x Q f32 block per (batch row, chunk)
            cbt = torch.empty(Bsz * nc * Q * Q, dtype=torch.float32, device=x.device)
            err = lib.repro_ssd_fwd(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                                    Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                                    cbt.data_ptr(), Bsz, S, H, P, N, Q, strides,
                                    stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    with _lock:
        ssd_kernel.launches += 1
    return y


ssd_kernel.launches = 0
