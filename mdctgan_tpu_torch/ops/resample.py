"""Polyphase windowed-sinc resampling as one strided ``conv1d``, and the
SNR-calibrated noise and fixed length of the reference's degradation.

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


def scale_noise_to_snr(waveform: torch.Tensor, noise: torch.Tensor, snr_db: float,
                       segment_length: int) -> torch.Tensor:
    """``waveform`` plus ``noise`` (same shape), centred and scaled per row
    so that the row's power over ``segment_length`` samples sits ``snr_db``
    above it (the reference's SNR-calibrated noise)."""
    noise = noise - noise.mean(dim=-1, keepdim=True)
    signal_power = waveform.square().sum(dim=-1, keepdim=True) / segment_length
    noise_var = signal_power / (10.0 ** (snr_db / 10.0))
    std = noise.std(dim=-1, keepdim=True, correction=0)
    return waveform + torch.sqrt(noise_var) / std * noise


def add_noise_snr(waveform: torch.Tensor, snr_db: float, segment_length: int,
                  generator: torch.Generator) -> torch.Tensor:
    """``scale_noise_to_snr`` of standard normal noise drawn on the CPU from
    ``generator`` (so the card and the CPU add the same noise); the draw is
    PyTorch's, not ``jax.random``'s."""
    noise = torch.randn(waveform.shape, generator=generator, dtype=waveform.dtype)
    return scale_noise_to_snr(waveform, noise.to(waveform.device), snr_db, segment_length)


def fix_length(waveform: torch.Tensor, length: int) -> torch.Tensor:
    """Crop or zero-pad the last axis to ``length``; the result is
    contiguous, as the kernels' inputs must be."""
    t = waveform.shape[-1]
    if t >= length:
        return waveform[..., :length].contiguous()
    return F.pad(waveform, (0, length - t))
