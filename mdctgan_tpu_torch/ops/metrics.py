"""Audio-quality metrics on tensors: MSE, SNR, segmental SNR, LSD.

The port of ``mdctgan_tpu/ops/metrics.py`` (the reference's
``compute_matrics``).  Each function runs on the device of its inputs.  LSD
is taken on a 2x-resolution STFT power spectrogram with a KBD window:
log10(|STFT|^2 + 1e-6), RMS over frequency, mean over frames.  Segmental
SNR follows the pysepm ``SNRseg`` recipe.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from mdctgan_tpu_torch.ops.window import kbd_window


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def snr_db(signal: torch.Tensor, estimate: torch.Tensor) -> torch.Tensor:
    """SNR of ``estimate`` against the reference ``signal``, mean over rows."""
    num = torch.sum(signal ** 2, dim=-1)
    den = torch.sum((signal - estimate) ** 2, dim=-1)
    return torch.mean(10.0 * torch.log10(num / torch.clamp(den, min=1e-20)))


def snr_seg(
    signal: torch.Tensor,
    estimate: torch.Tensor,
    fs: int,
    frame_len: float = 0.03,
    overlap: float = 0.75,
    min_snr: float = -10.0,
    max_snr: float = 35.0,
) -> torch.Tensor:
    """Segmental SNR of ``estimate`` against ``signal``: 30 ms Hann frames
    at 75% overlap, per-frame SNR clamped to [-10, 35] dB, the last frame
    dropped, mean over frames.  NaN for audio shorter than one frame."""
    eps = float(np.finfo(np.float64).eps)
    winlength = int(round(frame_len * fs))
    skiprate = int(np.floor((1.0 - overlap) * frame_len * fs))
    t = signal.shape[-1]
    if t < winlength:
        return torch.full((), float("nan"), dtype=signal.dtype, device=signal.device)
    # pysepm's Hann: 0.5*(1-cos(2*pi*(1..N)/(N+1)))
    n = np.arange(1, winlength + 1)
    window = torch.as_tensor(0.5 * (1.0 - np.cos(2.0 * np.pi * n / (winlength + 1))),
                             dtype=signal.dtype, device=signal.device)
    sf = signal.unfold(-1, winlength, skiprate) * window  # 1 + (t - N)//skip frames
    ef = estimate.unfold(-1, winlength, skiprate) * window
    sig_energy = torch.sum(sf ** 2, dim=-1)
    noise_energy = torch.sum((sf - ef) ** 2, dim=-1)
    seg = 10.0 * torch.log10(sig_energy / (noise_energy + eps) + eps)
    seg = torch.clamp(seg, min_snr, max_snr)
    if seg.shape[-1] > 1:
        seg = seg[..., :-1]  # pysepm drops the last (partial-energy) frame
    return torch.mean(seg)


def stft_power(
    audio: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    window: np.ndarray,
    center: bool = True,
) -> torch.Tensor:
    """|STFT|^2 with ``torch.stft``'s conventions: centre reflect-pad by
    n_fft//2, one-sided, (..., freq, time)."""
    if center:
        lead = audio.shape[:-1]
        audio = F.pad(audio.reshape(-1, 1, audio.shape[-1]), (n_fft // 2, n_fft // 2),
                      mode="reflect").reshape(*lead, -1)
    n_frames = 1 + (audio.shape[-1] - n_fft) // hop_length
    frames = audio.unfold(-1, win_length, hop_length)[..., :n_frames, :]
    frames = frames * torch.as_tensor(window, dtype=audio.dtype, device=audio.device)
    power = torch.fft.rfft(frames, n=n_fft, dim=-1).abs() ** 2
    return power.transpose(-1, -2)


def lsd(
    hr_audio: torch.Tensor,
    sr_audio: torch.Tensor,
    n_fft: int = 512,
    hop_length: int = 256,
    win_length: int = 512,
    center: bool = True,
) -> torch.Tensor:
    """Log-spectral distance at twice the transform's resolution."""
    w = kbd_window(2 * win_length)
    hs = stft_power(hr_audio, 2 * n_fft, 2 * hop_length, 2 * win_length, w, center)
    ss = stft_power(sr_audio, 2 * n_fft, 2 * hop_length, 2 * win_length, w, center)
    hl = torch.log10(hs + 1e-6)
    sl = torch.log10(ss + 1e-6)
    return torch.mean(torch.sqrt(torch.mean((hl - sl) ** 2, dim=-2)))


def nanmean_rows(rows: List[Mapping[str, float]]) -> Dict[str, float]:
    """Per-key mean over a list of metric dicts, NaNs left out (a clip
    shorter than one frame has a NaN ``snr_seg``); an all-NaN key stays
    NaN."""
    out: Dict[str, float] = {}
    for k in rows[0]:
        vals = np.asarray([r[k] for r in rows], np.float64)
        finite = vals[~np.isnan(vals)]
        out[k] = float(finite.mean()) if finite.size else float("nan")
    return out


def compute_metrics(
    hr_audio: torch.Tensor,
    lr_audio: torch.Tensor,
    sr_audio: torch.Tensor,
    n_fft: int = 512,
    hop_length: int = 256,
    win_length: int = 512,
    center: bool = True,
    fs: int = 48000,
) -> Dict[str, torch.Tensor]:
    """MSE, SNR of SR, SNR of LR, segmental SNR of SR and LSD, in that
    order (the order of ``metrics.csv``'s columns)."""
    return {
        "mse": mse(hr_audio, sr_audio),
        "snr_sr": snr_db(hr_audio, sr_audio),
        "snr_lr": snr_db(hr_audio, lr_audio),
        "snr_seg": snr_seg(hr_audio, sr_audio, fs),
        "lsd": lsd(hr_audio, sr_audio, n_fft, hop_length, win_length, center),
    }
