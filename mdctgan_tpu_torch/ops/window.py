"""Analysis/synthesis windows (host numpy, float64).

The Kaiser-Bessel-derived (KBD) window satisfies the Princen-Bradley
condition w[n]^2 + w[n + N/2]^2 = const, which makes the MDCT with
hop = N/2 perfectly reconstructing.  Built once on the host and folded into
the transform matrices; nothing here runs per call.
"""

from __future__ import annotations

import numpy as np


def kaiser_window(length: int, beta: float, periodic: bool = False) -> np.ndarray:
    """Kaiser window, matching torch.kaiser_window semantics.

    ``periodic=False`` gives the symmetric window; ``periodic=True`` computes a
    symmetric window of ``length+1`` points and drops the last one.
    """
    if length == 1:
        return np.ones(1, dtype=np.float64)
    m = length + 1 if periodic else length
    n = np.arange(m, dtype=np.float64)
    alpha = (m - 1) / 2.0
    arg = beta * np.sqrt(np.maximum(0.0, 1.0 - ((n - alpha) / alpha) ** 2))
    w = np.i0(arg) / np.i0(np.float64(beta))
    return w[:length] if periodic else w


def kbd_window(n: int, beta: float = 12.0) -> np.ndarray:
    """Kaiser-Bessel-derived window of even length ``n``: a symmetric Kaiser
    window of ``n//2 + 1`` points with shape parameter ``beta * pi``,
    cumulatively summed, normalised, square-rooted, and mirrored."""
    if n % 2 != 0:
        raise ValueError(f"KBD window length must be even, got {n}")
    w = kaiser_window(n // 2 + 1, beta * np.pi, periodic=False)
    half = np.sqrt(np.cumsum(w) / np.sum(w))[:-1]
    return np.concatenate([half, half[::-1]])
