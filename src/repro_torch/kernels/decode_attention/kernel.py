"""Binding of the hand-written CUDA decode attention,
``src/repro_torch/csrc/decode_attention.cu``: one token per row against a
ring KV cache, reading only the slots that hold a token, split over chunks
of slots (the split-KV form) and combined in a fixed order.

It replaces no Pallas kernel: the reference's decode attention is plain jnp
(``src/repro/models/attention.py:113-114``). The library is built with
``nvcc`` at the first launch (see :mod:`repro_torch.kernels.build`);
importing this module builds nothing. :func:`decode_attention_kernel` takes
CUDA tensors only: it launches the kernel or raises, and never falls back.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library

__all__ = ["decode_attention_kernel", "SOURCE", "HEAD_DIMS", "MAX_GROUP", "chunks"]

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "decode_attention.cu"
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
MAX_GROUP = 16                       # query heads per kv head
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_libs: dict = {}              # (is_bf16, D) -> library
_locks: dict = {}
_lock = threading.Lock()     # guards the tables and the launch counts: threads launch too


def _library(dtype: torch.dtype = torch.bfloat16, D: int = 128) -> ctypes.CDLL:
    """The library of the kernels for a cache of ``dtype`` at head_dim
    ``D``: each (dtype, head_dim) is built on its own (``-DREPRO_DECODE_BF16``
    and ``-DREPRO_DECODE_D``), so a model's first decode step compiles its
    own six kernels, not all 61; the defaults are the main path's (bf16, 128)."""
    key = (_DTYPES[dtype], int(D))
    with _lock:
        lock = _locks.setdefault(key, threading.Lock())
    with lock:
        if key not in _libs:
            lib = build_library(SOURCE, defines=(f"-DREPRO_DECODE_BF16={key[0]}",
                                                 f"-DREPRO_DECODE_D={key[1]}"))
            fn = lib.repro_decode_attention
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.repro_decode_attention_chunks.argtypes = [ctypes.c_int] * 6
            lib.repro_decode_attention_chunks.restype = ctypes.c_int
            lib.repro_decode_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
            lib.repro_decode_attention_smem_bytes.restype = ctypes.c_longlong
            with _lock:
                _libs[key] = lib
    return _libs[key]


def chunks(B: int, K: int, S: int, D: int, dtype: torch.dtype, _chunk_len: int = 0) -> int:
    """Chunks of slots one launch splits each (row, kv head) into, on the
    current device (the rule reads its SM count). ``_chunk_len`` > 0 forces
    the chunk's length (rounded up to whole tiles): a hook for checks and
    timing only, not an option."""
    return _library(dtype, D).repro_decode_attention_chunks(B, K, S, D, _DTYPES[dtype],
                                                            _chunk_len)


def _check(q, cache_k, cache_v, pos, window, slot0, ring) -> None:
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v), ("pos", pos)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES or cache_k.dtype not in _DTYPES:
        raise ValueError(f"dtypes {q.dtype}, {cache_k.dtype} not supported; use float32 or "
                         "bfloat16")
    if cache_v.dtype != cache_k.dtype or cache_v.shape != cache_k.shape:
        raise ValueError(f"cache_v {cache_v.dtype} {tuple(cache_v.shape)} does not match "
                         f"cache_k {cache_k.dtype} {tuple(cache_k.shape)}")
    if pos.dtype != torch.int64:
        raise ValueError(f"pos must be int64, got {pos.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or cache_k.dim() != 4:
        raise ValueError(f"q must be (B, 1, H, D) and the cache (B, S, K, D), got "
                         f"{tuple(q.shape)} and {tuple(cache_k.shape)}")
    B, _, H, D = q.shape
    S, K = cache_k.shape[1], cache_k.shape[2]
    if cache_k.shape[0] != B or cache_k.shape[3] != D or tuple(pos.shape) != (B,):
        raise ValueError(f"q {tuple(q.shape)}, cache {tuple(cache_k.shape)} and pos "
                         f"{tuple(pos.shape)} do not match")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported; have {HEAD_DIMS}")
    if K < 1 or H % K or H // K > MAX_GROUP:
        raise ValueError(f"H={H}, K={K}: need K | H and H / K <= {MAX_GROUP}")
    if B > 65535 or K > 65535:
        raise ValueError(f"B={B} and K={K} must be at most 65535 (the grid's z and y)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if slot0 < 0 or slot0 + S > ring:
        raise ValueError(f"slots {slot0}..{slot0 + S - 1} do not lie in a ring of {ring}")


def decode_attention_kernel(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                            pos: torch.Tensor, window: int | None = None, *, slot0: int = 0,
                            ring: int | None = None, with_lse: bool = False,
                            _chunk_len: int = 0):
    """q: (B, 1, H, D); cache_k, cache_v: (B, S, K, D), rings indexed
    ``pos % ring`` (``ring`` defaults to S; a cache sharded over its slots
    holds ``slot0 .. slot0 + S - 1``); pos: (B,) int64. Contiguous CUDA
    tensors; q and the cache each float32 or bfloat16. Returns the output
    (B, 1, H, D) in q's dtype, and with ``with_lse`` each (row, head)'s
    natural log-sum-exp of the scaled scores, (B, H) f32 (-inf where no slot
    of this cache is written). Scale D^-0.5. ``launches`` counts calls,
    ``combine_launches`` the calls that split the slots into more than one
    chunk and so launch the combine kernel too. ``_chunk_len`` > 0 forces the
    chunk's length: a hook for checks and timing only (the split rule has no
    knob), which no caller of the model sets."""
    ring = cache_k.shape[1] if ring is None else int(ring)
    _check(q, cache_k, cache_v, pos, window, slot0, ring)
    B, _, H, D = q.shape
    S, K = cache_k.shape[1], cache_k.shape[2]
    lib = _library(cache_k.dtype, D)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        n = lib.repro_decode_attention_chunks(B, K, S, D, _DTYPES[cache_k.dtype], _chunk_len)
        part_o = torch.empty((n, B, H, D) if n > 1 else (0,), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((n, B, H, 2) if n > 1 else (0,), dtype=torch.float32,
                              device=q.device)
        lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if with_lse else None
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_decode_attention(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), pos.data_ptr(),
            out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
            None if lse is None else lse.data_ptr(), B, S, H, K, D, ring, int(slot0),
            0 if window is None else int(window), _DTYPES[q.dtype], _DTYPES[cache_k.dtype],
            int(_chunk_len), D ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    with _lock:
        decode_attention_kernel.launches += 1
        decode_attention_kernel.combine_launches += n > 1
    return (out, lse) if with_lse else out


decode_attention_kernel.launches = 0
decode_attention_kernel.combine_launches = 0
