"""Architecture registry of the port.

``get(arch)`` returns the full published config, ``get_smoke(arch)`` the
reduced same-family config the CPU tests use. Only the architectures whose
family the port runs are listed; the others wait for their ROADMAP item.
"""

from __future__ import annotations

from repro_torch.configs import (granite_8b, llama3_405b, mamba2_130m, mistral_nemo_12b,
                                 mixtral_8x22b, moonshot_v1_16b_a3b, qwen2_5_14b,
                                 recurrentgemma_2b, tiny)
from repro_torch.configs.base import ModelConfig

_MODULES = {"granite-8b": granite_8b, "llama3-405b": llama3_405b,
            "mamba2-130m": mamba2_130m, "mistral-nemo-12b": mistral_nemo_12b,
            "mixtral-8x22b": mixtral_8x22b, "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
            "qwen2.5-14b": qwen2_5_14b, "recurrentgemma-2b": recurrentgemma_2b,
            "tiny": tiny}
ARCHS = sorted(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (have {ARCHS}); its family "
            "waits in ROADMAP.md Queue 1")
    return _MODULES[arch]


def get(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


__all__ = ["ModelConfig", "ARCHS", "get", "get_smoke"]
