"""How the reference multiplies: in float32 with TF32 off (the reference),
or with both operands rounded to float8 e4m3 first (the control, the step
below the configurations' bfloat16 that would tempt a later change)."""

from __future__ import annotations

import torch

__all__ = ["F32", "FP8", "no_tf32"]

_E4M3_MAX = 448.0


def no_tf32() -> None:
    """float32 matmuls and convolutions in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int | None) -> torch.Tensor:
    """``x`` rounded to e4m3, scaled so that its largest magnitude (per
    slice along ``dim``, or the whole tensor) maps to e4m3's largest."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Matmul:
    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def __call__(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``a @ w`` for activations a (..., K) and a weight w (K, N), in
        float32; the control rounds a per row and w per tensor to e4m3 and
        passes the gradient straight through the rounding."""
        a, w = a.float(), w.float()
        if self.fp8:
            a = a + (_fp8(a.detach(), -1) - a).detach()
            w = w + (_fp8(w.detach(), None) - w).detach()
        return a @ w


F32 = _Matmul(False)
FP8 = _Matmul(True)
