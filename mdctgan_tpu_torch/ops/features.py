"""Waveform <-> normalized MDCT-spectrogram "image" features.

The port of ``mdctgan_tpu/ops/features.py`` for the serving configuration:
arcsinh normalisation (``asinh(gain*x)/ln10``) followed by the fixed affine
map from ``src_range`` onto ``norm_range`` (``abs_norm``).  Because
``abs_norm`` makes the normalisation parameters constants, the whole of
``to_spectro`` is kernel K1 and the whole of ``to_audio`` is kernel K2
(``ops/mdct_kernels.py``): a CUDA tensor always launches them, a CPU tensor
runs their plain versions.

Not ported yet (they raise ``NotImplementedError``): the explicit, dB and raw
normalisations, per-sample min/max normalisation (``abs_norm=False``) and
spectral masking.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from mdctgan_tpu_torch.device import resolve_device
from mdctgan_tpu_torch.ops import mdct_kernels


@dataclasses.dataclass(frozen=True)
class SpectralConfig:
    """Static configuration of the waveform<->spectrogram transform (field
    names track the reference CLI flags)."""

    n_fft: int = 512
    hop_length: int = 256
    win_length: int = 512
    center: bool = True
    lr_sampling_rate: int = 16000
    hr_sampling_rate: int = 48000
    segment_length: int = 32512
    # normalization
    arcsinh_transform: bool = True
    arcsinh_gain: float = 1000.0
    explicit_encoding: bool = False
    raw_mdct: bool = False
    abs_norm: bool = True
    src_range: Tuple[float, float] = (-5.0, 5.0)
    norm_range: Tuple[float, float] = (-1.0, 1.0)
    # masking / residual
    mask: bool = False
    mask_hr: bool = False
    fit_residual: bool = True
    abs_spectro: bool = True

    @property
    def up_ratio(self) -> float:
        return self.hr_sampling_rate / self.lr_sampling_rate


def _unported(cfg: SpectralConfig) -> Optional[str]:
    if cfg.explicit_encoding:
        return "explicit_encoding"
    if cfg.raw_mdct:
        return "raw_mdct"
    if not cfg.arcsinh_transform:
        return "dB normalisation (arcsinh_transform=False)"
    if not cfg.abs_norm:
        return "per-sample normalisation (abs_norm=False)"
    if cfg.mask or cfg.mask_hr:
        return "spectral masking"
    if not cfg.center:
        return "center=False framing"
    return None


class SpectralTransform:
    """The MDCT/IMDCT matrices on one device plus the normalisation config.
    ``device`` defaults to the card and raises without CUDA
    (``device.resolve_device``); only an explicit ``"cpu"`` runs the plain
    versions."""

    def __init__(self, cfg: SpectralConfig, device="cuda", dtype=torch.float32):
        what = _unported(cfg)
        if what is not None:
            raise NotImplementedError(f"SpectralTransform: {what} is not ported")
        mdct_kernels.check_geometry(cfg.n_fft, cfg.hop_length, cfg.win_length)
        device = resolve_device(device)
        self.cfg = cfg
        self.spectro_mat = mdct_kernels.spectro_matrix(cfg.n_fft, device, dtype)
        self.synth_mat = mdct_kernels.synth_matrix(cfg.n_fft, device, dtype)

    def norm_param(self) -> Dict[str, float]:
        """The normalisation bounds; constants under ``abs_norm``."""
        return {"min": float(self.cfg.src_range[0]), "max": float(self.cfg.src_range[1])}

    # -------------------------------------------------------------- #
    # the affine maps between ``src_range`` and ``norm_range``
    # -------------------------------------------------------------- #
    def _norm_affine(self) -> Tuple[float, float]:
        """(scale, shift) taking ``src_range`` onto ``norm_range``."""
        (lo, hi), (r0, r1) = self.cfg.src_range, self.cfg.norm_range
        scale = (r1 - r0) / (hi - lo)
        return scale, r0 - lo * scale

    def _denorm_affine(self, lo: float, hi: float) -> Tuple[float, float]:
        """(scale, shift) taking ``norm_range`` back onto [lo, hi]."""
        r0, r1 = self.cfg.norm_range
        scale = (hi - lo) / (r1 - r0)
        return scale, lo - r0 * scale

    # -------------------------------------------------------------- #
    # normalize / denormalize (K1's epilogue and K2's prologue alone)
    # -------------------------------------------------------------- #
    def normalize(self, spectro: torch.Tensor):
        out = mdct_kernels.compress(spectro, self.cfg.arcsinh_gain, *self._norm_affine())
        return out, self.norm_param()

    def denormalize(self, log_spectro: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
        return mdct_kernels.expand(
            log_spectro, self.cfg.arcsinh_gain, *self._denorm_affine(lo, hi))

    # -------------------------------------------------------------- #
    # waveform <-> normalized spectro image
    # -------------------------------------------------------------- #
    def to_spectro(self, audio: torch.Tensor):
        """(B, T) waveform -> ((B, 1, F, K) normalized spectro, norm params).
        One K1 launch on a CUDA tensor."""
        log_spectro = mdct_kernels.mdct_spectro(
            audio, self.spectro_mat, self.cfg.arcsinh_gain, *self._norm_affine()
        )
        return log_spectro[:, None], self.norm_param()

    def lr_forward(self, lr_audio: torch.Tensor):
        """The LR branch of a train step.  Spectral masking is not ported
        (the constructor raises for it), so this is ``to_spectro``."""
        return self.to_spectro(lr_audio)

    def hr_forward(self, hr_audio: torch.Tensor):
        """The HR branch of a train step: ``to_spectro``, as ``lr_forward``."""
        return self.to_spectro(hr_audio)

    def to_audio(
        self,
        log_spectro: torch.Tensor,
        norm_param: Dict[str, float],
        out_length: Optional[int] = None,
    ) -> torch.Tensor:
        """(B, 1, F, K) normalized spectro -> (B, (F-1)*hop) waveform,
        denormalized with ``norm_param``.  One K2 launch on a CUDA tensor."""
        audio = mdct_kernels.imdct_audio(
            log_spectro[:, 0], self.synth_mat, self.cfg.arcsinh_gain,
            *self._denorm_affine(norm_param["min"], norm_param["max"]),
        )
        if out_length is not None:
            audio = audio[..., :out_length]
        return audio

    def abs_channel(self, log_spectro: torch.Tensor) -> torch.Tensor:
        """Second "abs" input channel (--abs_spectro with arcsinh):
        |x|*2 + norm_range[0]."""
        return torch.abs(log_spectro) * 2 + self.cfg.norm_range[0]

    def g_input(self, log_spectro: torch.Tensor) -> torch.Tensor:
        if self.cfg.abs_spectro:
            return torch.cat((log_spectro, self.abs_channel(log_spectro)), dim=1)
        return log_spectro
