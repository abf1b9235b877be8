"""What a run prints about the card, and the profiler it is traced with."""

from __future__ import annotations

import subprocess

import torch

__all__ = ["card_line", "device_info", "profiler", "say"]


def card_line() -> str:
    """The card's name and power limit, from ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired, IndexError) as exc:
        return f"nvidia-smi: {exc}"


def device_info(device, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": peak}


def profiler(device):
    """A ``torch.profiler.profile`` of the host and, on the card, the device."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def say(msg: str) -> None:
    """An earlier line of a run's standard output (not the result)."""
    print(f"[gpubench] {msg}", flush=True)
