"""Atomic, resumable checkpointing for train state (port of
``repro.train.checkpoint``).

Layout, the reference's: ``<dir>/step_<N:08d>/state.npz`` + ``meta.json``,
written into a temp dir and ``os.replace``d into place, so a crash
mid-save never corrupts the latest checkpoint; ``keep`` bounds disk use.
Leaves are keyed by their dict path joined with ``|``
(``params|layers|in_proj``, ``opt|mu|embed``, ``step``), the keys the JAX
package writes, so a checkpoint written by either package resumes in the
other: an OAR best-effort job can checkpoint and yield under one and resume
under the other.

A sharded state (DTensor leaves) is saved as its full arrays: every rank
takes part in gathering each leaf, rank 0 writes them (as the reference's
single-host file holds them) and the ranks meet at a barrier before the
save returns. A restore into a state whose leaves are DTensors places each
leaf by their layout, each rank keeping its own shard, so a job saved under
one mesh and rule set resumes under another, or on one device.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import full, place

__all__ = ["save", "restore_latest", "latest_step", "list_steps"]

_KEY_SEP = "|"


def _flatten(tree, prefix: tuple = ()) -> dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (k,)))
        return out
    return {_KEY_SEP.join(prefix): tree}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = full(t.detach()).cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save(ckpt_dir: str, state, step: int, *, keep: int = 3,
         extra_meta: dict | None = None) -> str:
    flat = _flatten(state)
    arrays = {k: _to_numpy(v) for k, v in flat.items()}   # every rank gathers
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    shared = any(isinstance(v, DTensor) for v in flat.values()) and \
        dist.get_world_size() > 1
    if shared and dist.get_rank() != 0:
        dist.barrier()                      # rank 0 writes; wait until it has
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=ckpt_dir)
    try:
        np.savez(os.path.join(tmp, "state.npz"), **arrays)
        meta = {"step": int(step), **(extra_meta or {})}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)              # atomic commit
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    if shared:
        dist.barrier()
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in list_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _fill(like, flat: dict, prefix: tuple, device):
    if isinstance(like, dict):
        return {k: _fill(like[k], flat, prefix + (k,), device) for k in sorted(like)}
    key = _KEY_SEP.join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint has no leaf {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, "
                         f"the state {tuple(like.shape)}")
    if arr.dtype.name == "bfloat16" or arr.dtype == np.dtype("V2"):
        # bf16 leaves: ml_dtypes' bfloat16, or the JAX package's np.savez
        # output, which stores them as raw 2-byte voids. Reinterpret the bits.
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    t = t.to(device=device, dtype=like.dtype)
    return place(t, like.placements, like.device_mesh) if isinstance(like, DTensor) else t


def restore_latest(ckpt_dir: str, state_like, device="cpu"):
    """Restore the newest checkpoint into the structure and dtypes of
    ``state_like`` (a nested dict of tensors, e.g. on the ``meta`` device;
    DTensor leaves give their layouts), on ``device``. Returns (state,
    step), or (None, None) when there is no checkpoint."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "state.npz")
    with np.load(path) as data:
        flat = dict(data.items())
    return _fill(state_like, flat, (), device), step
