"""MDCT / IMDCT as plain matrix products.

The transform is the real MDCT

    X[k] = sum_n  x[n] w[n] cos( (2*pi/N) * (n + 1/2 + N/4) * (k + 1/2) )

for ``n in [0, N)`` and ``k in [0, N/2)``: a (frames, N) @ (N, N/2) product
against a cosine matrix with the analysis window folded in.  The matrices are
built on the host in float64 and cast once.  The inverse is the product with
``(4/N) * (w * C)^T`` followed by the overlap-add of adjacent half-frames.

``mdct``/``imdct`` are the transform itself: the plain versions of the
serving kernels (``ops/mdct_kernels.py``) call them, and the ``MDCT``/``IMDCT``
classes hold a matrix and call them.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from mdctgan_tpu_torch.ops.window import kbd_window


@functools.lru_cache(maxsize=16)
def _mdct_matrix_f64(n_fft: int) -> np.ndarray:
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2, dtype=np.float64)[None, :]
    return np.cos((2.0 * np.pi / n_fft) * (n + 0.5 + n_fft / 4.0) * (k + 0.5))


def mdct_matrix(
    n_fft: int, window: Optional[np.ndarray] = None, dtype=np.float32
) -> np.ndarray:
    """(N, N/2) forward-MDCT matrix with the analysis window folded in."""
    m = _mdct_matrix_f64(n_fft)
    if window is not None:
        w = np.zeros(n_fft, dtype=np.float64)
        w[: len(window)] = np.asarray(window, dtype=np.float64)
        m = w[:, None] * m
    return m.astype(dtype)


def imdct_matrix(n_fft: int, window: np.ndarray, dtype=np.float32) -> np.ndarray:
    """(N/2, N) synthesis matrix ``(4/N) * (w * C)^T`` (window and scale
    folded in, built in float64)."""
    m = mdct_matrix(n_fft, window, dtype=np.float64)
    return np.ascontiguousarray((4.0 / n_fft) * m.T, dtype=dtype)


def frame_signal(
    signal: torch.Tensor, win_length: int, hop_length: int, center: bool = True
) -> torch.Tensor:
    """Slice ``(..., T)`` into overlapped windows ``(..., F, win_length)``.

    ``center=True`` zero-pads ``hop`` at both ends, plus end padding up to a
    multiple of ``hop`` (the reference's framing)."""
    t = signal.shape[-1]
    start_pad = hop_length if center else 0
    end_pad = start_pad + (-t) % hop_length
    signal = F.pad(signal, (start_pad, end_pad))
    return signal.unfold(-1, win_length, hop_length)


def overlap_add(frames: torch.Tensor, hop_length: int, center: bool = True) -> torch.Tensor:
    """Center-cropped overlap-add of ``(..., F, 2*hop)`` frames: output chunk
    ``c`` is ``frames[c, hop:] + frames[c+1, :hop]``, ``(F-1)*hop`` samples.
    Only the hop = win/2, ``center=True`` geometry of the serving chain."""
    if frames.shape[-1] != 2 * hop_length or not center:
        raise NotImplementedError(
            "overlap_add supports hop = win/2 with center=True only"
        )
    out = frames[..., :-1, hop_length:] + frames[..., 1:, :hop_length]
    return out.reshape(*out.shape[:-2], -1)


def spectro_matrix(n_fft: int, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """The (N, N/2) analysis matrix, KBD window folded in (float64 build)."""
    m = mdct_matrix(n_fft, kbd_window(n_fft), np.float64)
    return torch.as_tensor(m, dtype=dtype, device=device)


def synth_matrix(n_fft: int, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """The (N/2, N) synthesis matrix ``(4/N) (w C)^T`` (float64 build)."""
    s = imdct_matrix(n_fft, kbd_window(n_fft), np.float64)
    return torch.as_tensor(s, dtype=dtype, device=device)


def fft_tables(n_fft: int, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """The FFT kernels' window and twiddles in one flat tensor (float64
    build, cast once).  With M = N/2 and Q = N/4, complex values interleaved
    (re, im), in this order:

    ========  =====  ==========================================
    window    N      the KBD window ``w[n]``
    pre       Q      ``exp(-i pi (m + 1/4) / M)``
    roots     Q/2    ``exp(-2 i pi k / Q)``, the FFT's twiddles
    post      Q      ``exp(-i pi m / M)``
    post_inv  Q      ``(2/M) exp(-i pi m / M)``: the inverse's 4/N folded in
    ========  =====  ==========================================

    The forward (fold, ``pre``, Q-point FFT, ``post``, unpack) equals
    ``frame @ spectro_matrix(N)``; the inverse (``pre``, FFT, ``post_inv``,
    unpack, unfold, window) equals ``X @ synth_matrix(N)``."""
    if n_fft % 8:
        raise ValueError(f"fft_tables: n_fft must be a multiple of 8, got {n_fft}")
    m, q = n_fft // 2, n_fft // 4
    j = np.arange(q, dtype=np.float64)
    post = np.exp(-1j * np.pi * j / m)
    parts = [
        np.asarray(kbd_window(n_fft), dtype=np.float64),
        np.exp(-1j * np.pi * (j + 0.25) / m),
        np.exp(-2j * np.pi * j[: q // 2] / q),
        post,
        (2.0 / m) * post,
    ]
    flat = np.concatenate([
        p if p.dtype == np.float64 else np.stack([p.real, p.imag], -1).reshape(-1)
        for p in parts
    ])
    return torch.as_tensor(flat, dtype=dtype, device=device)


def mdct(signal: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Centre-padded MDCT ``(..., T)`` -> ``(..., F, N/2)``; ``mat`` from
    ``spectro_matrix``."""
    n_fft = mat.shape[0]
    return torch.matmul(frame_signal(signal, n_fft, n_fft // 2, center=True), mat)


def imdct(spectrum: torch.Tensor, synth: torch.Tensor) -> torch.Tensor:
    """Inverse MDCT ``(..., F, N/2)`` -> ``(..., (F-1)*N/2)``, centre-cropped;
    ``synth`` from ``synth_matrix``."""
    return overlap_add(torch.matmul(spectrum, synth), synth.shape[0], center=True)


class MDCT:
    """Forward MDCT: waveform ``(..., T)`` -> spectrum ``(..., F, n_fft//2)``,
    KBD window, hop = win/2 = n_fft/2, centre-padded."""

    def __init__(self, n_fft: int = 512, device="cpu", dtype=torch.float32):
        self.kernel = spectro_matrix(n_fft, device, dtype)

    def __call__(self, signal: torch.Tensor) -> torch.Tensor:
        return mdct(signal, self.kernel)


class IMDCT:
    """Inverse MDCT: spectrum ``(..., F, n_fft//2)`` -> waveform
    ``(..., (F-1)*hop)``, hop = n_fft/2, centre-cropped."""

    def __init__(self, n_fft: int = 512, device="cpu", dtype=torch.float32):
        self.kernel = synth_matrix(n_fft, device, dtype)

    def __call__(self, spectrum: torch.Tensor) -> torch.Tensor:
        return imdct(spectrum, self.kernel)
