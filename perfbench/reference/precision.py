"""The arithmetic of the reference's convolutions and products.

``FLOAT32`` is the reference itself.  ``FP8`` is the control: the step
below the configuration's bf16 that a later change might take, float8
e4m3 operands with one scale a tensor (its largest magnitude onto e4m3's
448), products and sums in float32.  The rounding passes gradients
straight through, so the control trains as a fp8 forward would.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in
    ``x``'s dtype; the gradient passes through unchanged."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


class Precision:
    """How operands enter a convolution: ``cast(x)`` on the input and the
    weight."""

    def __init__(self, name: str, cast):
        self.name, self.cast = name, cast

    def __repr__(self) -> str:
        return f"Precision({self.name})"


FLOAT32 = Precision("float32", lambda x: x)
FP8 = Precision("fp8_e4m3", round_e4m3)
