"""Waveform <-> normalised MDCT spectrum, and the resample, in float32.

The MDCT of a frame x (N samples, KBD window w, hop N/2, centre-padded by
one hop at each end):

    X[k] = sum_n x[n] w[n] cos((2 pi / N) (n + 1/2 + N/4) (k + 1/2)),

computed as a (frames, N) @ (N, N/2) product whose matrix is built on the
host in float64.  The spectrum is compressed by ``asinh(gain x) / ln 10``
and mapped affinely from ``src_range`` onto ``norm_range`` (the flagship's
``abs_norm``); the inverse expands, multiplies by ``(4/N) (w C)^T`` and
overlap-adds the half frames.  The resample is torchaudio's
``sinc_interp_hann`` polyphase filter (width 6, rolloff 0.99) as one
strided ``conv1d``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

LN10 = math.log(10.0)


def kbd_window(n: int, beta: float = 12.0) -> np.ndarray:
    """Kaiser-Bessel-derived window of even length ``n`` (float64)."""
    m = n // 2 + 1
    k = np.arange(m, dtype=np.float64)
    alpha = (m - 1) / 2.0
    arg = beta * np.pi * np.sqrt(np.maximum(0.0, 1.0 - ((k - alpha) / alpha) ** 2))
    w = np.i0(arg) / np.i0(np.float64(beta * np.pi))
    half = np.sqrt(np.cumsum(w) / np.sum(w))[:-1]
    return np.concatenate([half, half[::-1]])


def analysis_matrix(n_fft: int) -> np.ndarray:
    """(N, N/2) float64: the window folded into the MDCT's cosines."""
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2, dtype=np.float64)[None, :]
    return kbd_window(n_fft)[:, None] * np.cos(
        (2.0 * np.pi / n_fft) * (n + 0.5 + n_fft / 4.0) * (k + 0.5))


class Transform:
    """The flagship's transform at ``n_fft`` (hop N/2, centred) on
    ``device``, normalising ``src_range`` onto ``norm_range``."""

    def __init__(self, n_fft: int, gain: float, src_range: Tuple[float, float],
                 norm_range: Tuple[float, float], device):
        self.n_fft, self.hop, self.gain = n_fft, n_fft // 2, gain
        self.src_range, self.norm_range = tuple(src_range), tuple(norm_range)
        a = analysis_matrix(n_fft)
        self.analysis = torch.as_tensor(a, dtype=torch.float32, device=device)
        self.synthesis = torch.as_tensor((4.0 / n_fft) * a.T, dtype=torch.float32,
                                         device=device)

    def spectrum(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, T) -> normalised (B, 1, frames, N/2)."""
        t, hop = audio.shape[-1], self.hop
        x = F.pad(audio, (hop, hop + (-t) % hop))
        spec = torch.matmul(x.unfold(-1, self.n_fft, hop), self.analysis)
        (lo, hi), (r0, r1) = self.src_range, self.norm_range
        log = torch.asinh(self.gain * spec) / LN10
        return ((log - lo) / (hi - lo) * (r1 - r0) + r0)[:, None]

    def audio(self, spec: torch.Tensor) -> torch.Tensor:
        """Normalised (B, 1, frames, N/2) -> (B, (frames - 1) N/2)."""
        (lo, hi), (r0, r1) = self.src_range, self.norm_range
        x = (spec[:, 0] - r0) / (r1 - r0) * (hi - lo) + lo
        frames = torch.matmul(torch.sinh(x * LN10) / self.gain, self.synthesis)
        hop = self.hop
        out = frames[..., :-1, hop:] + frames[..., 1:, :hop]
        return out.reshape(out.shape[0], -1)


def sinc_kernel(orig_freq: int, new_freq: int, width_zeros: int = 6,
                rolloff: float = 0.99) -> Tuple[np.ndarray, int]:
    """Polyphase kernels (new phases, taps) in float64 and the half-width."""
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    base = min(orig, new) * rolloff
    width = int(math.ceil(width_zeros * orig / base))
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    phase = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new
    t = np.clip((phase + idx) * base, -width_zeros, width_zeros)
    window = np.cos(t * np.pi / width_zeros / 2) ** 2
    t = t * np.pi
    k = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    return k * window * (base / orig), width


def resample(x: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """(..., T) -> (..., ceil(T new / orig)) in ``x``'s dtype."""
    if orig_freq == new_freq:
        return x
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    kernels, width = sinc_kernel(orig_freq, new_freq)
    t, lead = x.shape[-1], x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, t), (width, width + orig))
    k = torch.as_tensor(kernels, dtype=x.dtype, device=x.device)
    y = F.conv1d(xp, k[:, None, :], stride=orig).transpose(1, 2).reshape(xp.shape[0], -1)
    n = int(math.ceil(t * new / orig))
    return y[:, :n].reshape(*lead, n)


def fix_length(x: torch.Tensor, length: int) -> torch.Tensor:
    t = x.shape[-1]
    return x[..., :length] if t >= length else F.pad(x, (0, length - t))


def degrade(wave: torch.Tensor, orig_freq: int, lr_freq: int, hr_freq: int,
            segment_length: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crops at ``orig_freq`` -> (LR, HR) at ``hr_freq``, both fixed to
    ``segment_length``: the HR resampled, the LR down to ``lr_freq`` and
    back."""
    hr = resample(wave, orig_freq, hr_freq)
    lr = resample(resample(wave, orig_freq, lr_freq), lr_freq, hr_freq)
    return fix_length(lr, segment_length), fix_length(hr, segment_length)
