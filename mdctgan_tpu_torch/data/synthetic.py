"""Synthetic test audio, made from a seed (no corpus is downloaded)."""

from __future__ import annotations

import numpy as np


def speech_like(rng: np.random.Generator, seconds: float, rate: int = 16000) -> np.ndarray:
    """Harmonic-plus-noise signal: 11 harmonics of a fundamental gliding
    around 140 Hz, amplitude 0.2/k, plus noise of sigma 0.003."""
    n = int(round(seconds * rate))
    t = np.arange(n) / rate
    f0 = 140.0 + 40.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / rate
    x = sum(0.2 / k * np.sin(k * phase) for k in range(1, 12))
    return (x + 0.003 * rng.standard_normal(n)).astype(np.float32)
