"""Polyphase windowed-sinc resampling as one strided ``conv1d``.

The kernels are built on the host in float64 (torchaudio's
``sinc_interp_hann`` design: lowpass_filter_width 6, rolloff 0.99, Hann^2
window).  On the card ``api.upsample`` runs the ``conv1d`` in full float32
under the port's precision policy (``device.float32_policy``).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=32)
def sinc_resample_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> Tuple[np.ndarray, int]:
    """Polyphase kernels (new_freq//g phases, taps) and the half-width."""
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    base_freq = min(orig, new) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig / base_freq))
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    phase = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new
    t = (phase + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels *= window * (base_freq / orig)
    return kernels.astype(np.float32), width


def resample(
    waveform: torch.Tensor,
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> torch.Tensor:
    """Resample ``(..., T)`` from orig_freq to new_freq; output length is
    ceil(T * new / orig)."""
    if orig_freq == new_freq:
        return waveform
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    kernels, width = sinc_resample_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff)
    t = waveform.shape[-1]
    lead = waveform.shape[:-1]
    x = F.pad(waveform.reshape(-1, 1, t), (width, width + orig))
    k = torch.as_tensor(kernels, dtype=waveform.dtype, device=waveform.device)
    y = F.conv1d(x, k[:, None, :], stride=orig)  # (N, new, frames)
    y = y.transpose(1, 2).reshape(x.shape[0], -1)  # interleave the phases
    target_len = int(math.ceil(t * new / orig))
    return y[:, :target_len].reshape(*lead, target_len)


def degrade_lr(waveform: torch.Tensor, orig_freq: int, lr_freq: int,
               hr_freq: int) -> torch.Tensor:
    """orig -> lr -> hr: the band-limited LR waveform at the HR rate."""
    return resample(resample(waveform, orig_freq, lr_freq), lr_freq, hr_freq)
