"""Architecture registry of the port.

``get(arch)`` returns the full published config, ``get_smoke(arch)`` the
reduced same-family config the CPU tests use. Every architecture of the
reference is listed; any other name raises ``NotImplementedError``.
"""

from __future__ import annotations

from repro_torch.configs import (granite_8b, internvl2_26b, llama3_405b, mamba2_130m,
                                 mistral_nemo_12b, mixtral_8x22b, moonlight_16b_a3b,
                                 moonshot_v1_16b_a3b,
                                 qwen2_5_14b, recurrentgemma_2b, seamless_m4t_large_v2, tiny)
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig, cell_supported,
                                      shape_for)

_MODULES = {"granite-8b": granite_8b, "internvl2-26b": internvl2_26b,
            "llama3-405b": llama3_405b,
            "mamba2-130m": mamba2_130m, "mistral-nemo-12b": mistral_nemo_12b,
            "mixtral-8x22b": mixtral_8x22b, "moonlight-16b-a3b": moonlight_16b_a3b,
            "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
            "qwen2.5-14b": qwen2_5_14b, "recurrentgemma-2b": recurrentgemma_2b,
            "seamless-m4t-large-v2": seamless_m4t_large_v2, "tiny": tiny}
ARCHS = sorted(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: the port has {ARCHS}")
    return _MODULES[arch]


def get(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "shape_for", "cell_supported",
           "ARCHS", "get", "get_smoke"]
