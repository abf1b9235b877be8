"""Binding of the hand-written CUDA latent (MLA) decode attention,
``src/repro_torch/csrc/mla_decode_attention.cu``: one token of up to 16
heads per row against the row's latent cache, reading only the written
slots, split over chunks of slots and combined in a fixed order, as the
GQA decode kernel does (both share ``csrc/split_kv.cuh``).

It replaces no Pallas kernel: the JAX reference has no latent attention.
Each (dtype, latent width C, rope width R) is its own library, built with
``nvcc`` at its first launch (see :mod:`repro_torch.kernels.build`);
importing this module builds nothing. :func:`mla_decode_kernel` takes CUDA
tensors only: it launches the kernel or raises, and never falls back.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library

__all__ = ["mla_decode_kernel", "SOURCE", "MAX_HEADS", "chunks"]

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "mla_decode_attention.cu"
MAX_HEADS = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_libs: dict = {}              # (is_bf16, C, R) -> library
_locks: dict = {}
_lock = threading.Lock()     # guards the tables and the launch counts


def _library(dtype: torch.dtype = torch.bfloat16, C: int = 512, R: int = 64) -> ctypes.CDLL:
    """The library of the kernels for a cache of ``dtype``, latent width C
    and rope width R (``-DREPRO_MLA_BF16``, ``-DREPRO_MLA_DC``,
    ``-DREPRO_MLA_DR``); the defaults are the published widths in bf16."""
    key = (_DTYPES[dtype], int(C), int(R))
    with _lock:
        lock = _locks.setdefault(key, threading.Lock())
    with lock:
        if key not in _libs:
            lib = build_library(SOURCE, defines=(f"-DREPRO_MLA_BF16={key[0]}",
                                                 f"-DREPRO_MLA_DC={key[1]}",
                                                 f"-DREPRO_MLA_DR={key[2]}"))
            fn = lib.repro_mla_decode_attention
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                       ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.repro_mla_decode_chunks.argtypes = [ctypes.c_int] * 3
            lib.repro_mla_decode_chunks.restype = ctypes.c_int
            lib.repro_mla_decode_smem_bytes.argtypes = []
            lib.repro_mla_decode_smem_bytes.restype = ctypes.c_longlong
            with _lock:
                _libs[key] = lib
    return _libs[key]


def chunks(B: int, S: int, dtype: torch.dtype, C: int, R: int, _chunk_len: int = 0) -> int:
    """Chunks of slots one launch splits each row into, on the current
    device (the shared rule reads its SM count). ``_chunk_len`` > 0 forces
    the chunk's length: a hook for checks and timing only."""
    return _library(dtype, C, R).repro_mla_decode_chunks(B, S, _chunk_len)


def _check(q, cache, pos, v_dim) -> None:
    for name, t in (("q", q), ("cache", cache), ("pos", pos)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES or cache.dtype != q.dtype:
        raise ValueError(f"q {q.dtype} and cache {cache.dtype} must be one of float32 or "
                         "bfloat16")
    if pos.dtype != torch.int64:
        raise ValueError(f"pos must be int64, got {pos.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or cache.dim() != 3:
        raise ValueError(f"q must be (B, 1, H, C + R) and the cache (B, S, C + R), got "
                         f"{tuple(q.shape)} and {tuple(cache.shape)}")
    B, _, H, W = q.shape
    if cache.shape[0] != B or cache.shape[2] != W or tuple(pos.shape) != (B,):
        raise ValueError(f"q {tuple(q.shape)}, cache {tuple(cache.shape)} and pos "
                         f"{tuple(pos.shape)} do not match")
    if not 1 <= H <= MAX_HEADS:
        raise ValueError(f"{H} heads; the kernel takes 1 to {MAX_HEADS}")
    if not 0 < v_dim < W or v_dim % 8 or (W * q.element_size()) % 16:
        raise ValueError(f"C={v_dim} of a slot of {W}: C must be a multiple of 8 and the slot "
                         "whole 16-byte vectors")
    if q.dtype == torch.bfloat16 and W % 16:
        raise ValueError(f"a bf16 slot of {W} values: the tensor-core route needs a multiple "
                         "of 16")
    if B > 65535:
        raise ValueError(f"B={B} must be at most 65535 (the grid's y)")


def mla_decode_kernel(q: torch.Tensor, cache: torch.Tensor, pos: torch.Tensor, v_dim: int,
                      scale: float, *, _chunk_len: int = 0) -> torch.Tensor:
    """q: (B, 1, H, C + R); cache: (B, S, C + R), a ring indexed ``pos %
    S`` whose first C values of a slot serve as V; pos: (B,) int64.
    Contiguous CUDA tensors, both float32 or both bfloat16. Returns (B, 1, H,
    C) in q's dtype. ``launches`` counts calls, ``combine_launches`` the
    calls that split the slots into more than one chunk and so launch the
    combine kernel too. ``_chunk_len`` > 0 forces the chunk's length: a hook
    for checks and timing only."""
    _check(q, cache, pos, v_dim)
    B, _, H, W = q.shape
    S, C, R = cache.shape[1], int(v_dim), W - int(v_dim)
    lib = _library(q.dtype, C, R)
    out = torch.empty((B, 1, H, C), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        n = lib.repro_mla_decode_chunks(B, S, _chunk_len)
        part_o = torch.empty((n, B, H, C) if n > 1 else (0,), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((n, B, H, 2) if n > 1 else (0,), dtype=torch.float32,
                              device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_mla_decode_attention(
            q.data_ptr(), cache.data_ptr(), pos.data_ptr(), out.data_ptr(), part_o.data_ptr(),
            part_ml.data_ptr(), B, S, H, C, R, _DTYPES[q.dtype], int(_chunk_len), float(scale),
            stream)
    if err != 0:
        raise RuntimeError(f"mla_decode_attention kernel launch failed: CUDA error {err}")
    with _lock:
        mla_decode_kernel.launches += 1
        mla_decode_kernel.combine_launches += n > 1
    return out


mla_decode_kernel.launches = 0
mla_decode_kernel.combine_launches = 0
