"""The least time of the transform kernels, and the card's peaks.

A copy of ``chip_smoke.py``'s ``PEAKS``, ``AFFINE_OPS``, ``mdct_frame_ops``
and ``bound_ms``, frozen here: the least work of the function, whatever
computes it.  Each frame by the FFT, each input byte read once and each
output byte written once; the window of N floats is the only table the
function needs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

# NVIDIA's data sheets, dense rates without sparsity: float32 outside the
# tensor cores, memory bytes/s, TF32 and bf16 tensor-core rates
PEAKS = {
    "sxm": {"f32": 67e12, "bytes": 3.35e12, "tf32": 495e12, "bf16": 989e12},
    "pcie": {"f32": 51e12, "bytes": 2.0e12, "tf32": 378e12, "bf16": 756e12},
}
# K1's epilogue and K2's prologue per spectrum value: the gain, asinh or
# sinh, the ln10 scale and the affine FMA
AFFINE_OPS = 4


def peaks_for(kind: str) -> Optional[dict]:
    """The peaks of a card by its ``torch.cuda.get_device_name``; None for
    a card the table does not hold."""
    if "H100" not in kind:
        return None
    return PEAKS["pcie" if "PCIe" in kind else "sxm"]


def mdct_frame_ops(n: int) -> float:
    """Operations of one N-point MDCT or IMDCT frame through an N/4-point
    complex FFT: the window (N), the fold (N/2), two twiddle passes of N/4
    complex products (6 each) and the FFT (5 (N/4) log2(N/4))."""
    m = n // 4
    return n + n / 2 + 2 * 6 * m + 5 * m * math.log2(m)


def n_frames(t: int, n: int) -> int:
    """Frames of a (hop N/2, centred) framing of ``t`` samples."""
    hop = n // 2
    return (t + 2 * hop + (-t) % hop - n) // hop + 1


def bound_s(flops: float, nbytes: float, peaks: dict) -> Tuple[float, str]:
    t_ops, t_bytes = flops / peaks["f32"], nbytes / peaks["bytes"]
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound_s(rows: int, t: int, n: int, peaks: dict) -> float:
    """K1 on ``rows`` waveforms of ``t`` samples: the spectrum of every
    frame, compressed."""
    f, k = n_frames(t, n), n // 2
    return bound_s(rows * f * (mdct_frame_ops(n) + AFFINE_OPS * k),
                   4.0 * (rows * t + n + rows * f * k), peaks)[0]


def k2_bound_s(rows: int, f: int, n: int, peaks: dict) -> float:
    """K2 on ``rows`` spectra of ``f`` frames: expanded, synthesised and
    overlap-added."""
    k = n // 2
    return bound_s(rows * f * (AFFINE_OPS * k + mdct_frame_ops(n)) + rows * (f - 1) * k,
                   4.0 * (rows * f * k + n + rows * (f - 1) * k), peaks)[0]
