"""Operand rounding for the reference's matrix products and convolutions.

``Precision("fp32")`` leaves operands as they are (the reference).  The
lower modes round both operands of every product before an fp32 product
with TF32 off, with a straight-through gradient: ``tf32`` to a 10-bit
mantissa (round to nearest), ``fp8`` to float8 e4m3 under one scale a
tensor (its absolute maximum onto 448), ``int8`` to 255 symmetric levels
under one scale a tensor (its absolute maximum onto 127).  They stand in for a
program that computes in that precision (the check's control: one step
below fp32 and below bf16), on the CPU as on the card.
"""

from __future__ import annotations

import torch

MODES = ("fp32", "tf32", "fp8", "int8")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & -0x2000
    return bits.view(torch.float32)


def _int8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    scale = 127.0 / torch.clamp(x.detach().abs().amax(), min=1e-30)
    return torch.round(x * scale) / scale


def _fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    scale = 448.0 / torch.clamp(x.detach().abs().amax(), min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


_ROUND = {"tf32": _tf32, "fp8": _fp8, "int8": _int8}


class Precision:
    """Rounds an operand to ``mode`` (forward only; the gradient passes
    through unchanged)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r}, one of {MODES}")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp32":
            return x
        with torch.no_grad():
            r = _ROUND[self.mode](x)
        return x + (r - x).detach()

    def __repr__(self) -> str:
        return f"Precision({self.mode!r})"


EXACT = Precision("fp32")
