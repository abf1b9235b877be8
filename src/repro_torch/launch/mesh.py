"""Mesh construction (port of ``repro.launch.mesh``) and the card's
datasheet numbers.

``make_local_mesh`` builds a ``(data, model)`` ``DeviceMesh`` over the
ranks of the default process group: under ``torchrun`` the whole world; in
a plain process, which has no group, a one-rank group that it starts
itself (gloo on the CPU, nccl on ``cuda``, on an in-process ``HashStore``).
It never falls back to an unsharded path: a missing group is started, a
world that does not split raises.

``make_production_mesh`` builds the reference's production shapes, (16, 16)
over (data, model) and (2, 16, 16) over (pod, data, model), over a *fake*
process group of 256 or 512 ranks: no collective runs, so it serves only
the dry-run on the ``meta`` device (:mod:`repro_torch.launch.dryrun`). On
H100 systems a node holds 8 cards on NVLink, so a 16-way `model` axis spans
two nodes and its collectives cross the slower inter-node links: the
dry-run's collective term, taken at NVLink's rate, is a lower bound there.
"""

from __future__ import annotations

import os
import threading

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["HW", "make_local_mesh", "make_production_mesh", "FAKE_BACKEND"]

# NVIDIA H100 SXM5 80GB, per card: datasheet values (spec, not measured).
HW = {
    "peak_flops_bf16": 989e12,     # FLOP/s, dense tensor cores
    "peak_flops_f32": 67e12,       # FLOP/s, outside the tensor cores
    "hbm_bw": 3.35e12,             # B/s
    "link_bw": 450e9,              # B/s, NVLink 4 per direction
    "hbm_bytes": 80e9,             # B
}

FAKE_BACKEND = "fake"
_lock = threading.Lock()         # one group start, whichever thread asks first


def _start_one_rank_group(device: torch.device) -> None:
    backend = "gloo"
    if device.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(device.index or 0)     # NCCL's device, before the mesh
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_local_mesh(model_parallel: int = 1, device: str | torch.device = "cuda") -> DeviceMesh:
    """A ``(world // model_parallel, model_parallel)`` mesh named
    ``("data", "model")`` over the default group's ranks on ``device``'s
    type. Without a group it joins the one ``torchrun`` describes (``RANK``
    in the environment) or, with none, starts a one-rank group."""
    device_type = torch.device(device).type
    with _lock:
        if not dist.is_initialized():
            if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
                if device_type == "cuda":
                    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
                dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
            else:
                _start_one_rank_group(torch.device(device))
        world = dist.get_world_size()
        if dist.get_backend() == FAKE_BACKEND:
            raise RuntimeError("the default process group is the dry-run's fake one; "
                               "destroy it before building a local mesh")
        if model_parallel < 1 or world % model_parallel:
            raise ValueError(f"world size {world} does not split into model-parallel "
                             f"groups of {model_parallel}")
        return init_device_mesh(device_type, (world // model_parallel, model_parallel),
                                mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's production mesh over a fake group (dry-run only):
    starts the fake group when there is none, reuses it when it has the
    right size, replaces a fake one of another size, and raises over a
    real one."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized():
        if dist.get_backend() != FAKE_BACKEND:
            raise RuntimeError(
                f"a {dist.get_backend()} group of {dist.get_world_size()} ranks is "
                f"running; the dry-run needs a fake group of {world}")
        if dist.get_world_size() != world:      # the other production mesh's
            dist.destroy_process_group()
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0, world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=names)
