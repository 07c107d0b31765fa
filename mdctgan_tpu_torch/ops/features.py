"""Waveform <-> normalized MDCT-spectrogram "image" features.

The port of ``mdctgan_tpu/ops/features.py``.  Normalization modes:

  * ``arcsinh``  -- ``asinh(gain*x)/ln10`` (the flagship's);
  * ``explicit`` -- two dB channels of the positive and negative parts,
    mixed by ``alpha``;
  * ``raw``      -- the identity;
  * ``db``       -- ``20*log10(|x| + min_value)`` (``amplitude_to_DB``);

each followed by the affine map from ``src_range`` (``abs_norm``) or from
the per-sample min/max onto ``norm_range``.

Two forms compute the transform, and the constructor picks one from the
configuration, before any launch (``fused_compatible``, the JAX package's
``_fused_compatible``): arcsinh with ``abs_norm``, centred, win = n_fft =
2*hop, float32, increasing ranges and an n_fft within the dense form's
range (``mdct_kernels.dense_max_n``) run kernels K1 and K2
(``ops/mdct_kernels.py``), whose epilogue and prologue are the whole
normalization, as the JAX package runs its Pallas kernels there; masking
comes after K1.  Every other configuration runs the matmul form
(``ops/mdct.py`` ``MDCT``/``IMDCT``) and the normalization here, as the
JAX package runs its XLA matmul.  Nothing falls back from one to the other:
the kernel wrappers raise on a CUDA tensor they cannot serve.

The random draws (the mask's noise fill, the dB path's pseudo-phase) come
from an explicit CPU ``torch.Generator`` and are moved to the data's
device, so the card and the CPU draw the same values; without a generator
the fill is zeros and the pseudo-phase ones, as without an ``rng`` in JAX.

Under data parallelism (``parallel/mesh.py``) a call holds some rows of a
global batch, named by ``rows`` = (its first row, the global rows): each
draw is made at the global shape and this call's rows kept (the fill's
scale is the global draw's range), so every rank or replica draws what one
device would, as the JAX package draws with one key over its mesh.  K1 and
K2 run on the call's own rows only: the port's counterpart of the JAX
package's ``_shard_mapped``, which runs the Pallas kernels per shard.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch

from mdctgan_tpu_torch.device import resolve_device
from mdctgan_tpu_torch.ops import mdct_kernels
from mdctgan_tpu_torch.ops.mdct import IMDCT, MDCT, n_frames

_LN10 = math.log(10.0)

# The normalization bounds: floats under ``abs_norm``, else (B, C, 1, 1)
# tensors of each sample's min and max.
NormParam = Dict[str, Union[float, torch.Tensor]]
# (first row, global rows) of a call's share of a global batch
Rows = Optional[Tuple[int, int]]


def _draw_shape(shape: Tuple[int, ...], rows: Rows) -> Tuple[int, ...]:
    """The shape a draw for ``shape`` is made at: the global batch's."""
    return tuple(shape) if rows is None else (rows[1], *shape[1:])


def _own_rows(x: torch.Tensor, rows: Rows, b: int) -> torch.Tensor:
    """A draw at the global shape -> the ``b`` rows of this call."""
    return x if rows is None else x[rows[0]:rows[0] + b]


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
    sr_sampling_rate: int = 48000
    segment_length: int = 32512
    # normalization
    arcsinh_transform: bool = True
    arcsinh_gain: float = 1000.0
    explicit_encoding: bool = False
    alpha: float = 0.6
    raw_mdct: bool = False
    abs_norm: bool = True
    src_range: Tuple[float, float] = (-5.0, 5.0)
    norm_range: Tuple[float, float] = (-1.0, 1.0)
    min_value: float = 1e-7
    # masking / residual
    mask: bool = False
    mask_hr: bool = False
    fit_residual: bool = True
    abs_spectro: bool = True

    @property
    def up_ratio(self) -> float:
        return self.hr_sampling_rate / self.lr_sampling_rate

    @property
    def n_bins(self) -> int:
        """Time bins of a segment (128 for the default geometry)."""
        return n_frames(self.segment_length, self.win_length, self.hop_length, self.center)

    @property
    def lr_mask_size(self) -> int:
        """High-frequency columns masked on the LR spectrogram."""
        return int((self.n_fft // 2) * (1 - 1 / self.up_ratio))

    @property
    def hr_mask_size(self) -> int:
        """High-frequency columns masked on the HR spectrogram."""
        return int(self.n_fft * (1 - self.sr_sampling_rate / self.hr_sampling_rate) // 2)


def fused_compatible(cfg: SpectralConfig, dtype=torch.float32, device=None) -> bool:
    """Whether K1/K2 serve ``cfg``: the JAX package's ``_fused_compatible``,
    and an n_fft within the dense form's range on ``device``
    (``mdct_kernels.dense_max_n``; sm_90's when None).  That limit departs
    from the JAX function, which has none: the Pallas kernels stop at a size
    too, where the whole (N, N/2) matrix no longer fits in VMEM, but JAX
    finds it only when it compiles.  The port's limit comes from the card's
    shared memory and is known here, so a larger n_fft runs the matmul form
    by configuration, never after a failed launch."""
    return (
        cfg.arcsinh_transform
        and not cfg.explicit_encoding
        and not cfg.raw_mdct
        and cfg.abs_norm
        and cfg.center
        and cfg.win_length == cfg.n_fft
        and cfg.hop_length * 2 == cfg.win_length
        and dtype == torch.float32
        and cfg.src_range[1] > cfg.src_range[0]
        and cfg.norm_range[1] > cfg.norm_range[0]
        and cfg.n_fft <= mdct_kernels.dense_max_n(device)
    )


def amplitude_to_db(x: torch.Tensor, amin: float) -> torch.Tensor:
    """``torchaudio.functional.amplitude_to_DB`` with multiplier 20."""
    return 20.0 * torch.log10(torch.clamp(x, min=amin)) - 20.0


def db_to_amplitude(x: torch.Tensor, ref: float = 10.0, power: float = 0.5) -> torch.Tensor:
    """``torchaudio.functional.DB_to_amplitude``: ``ref * 10^(x*power/10)``."""
    return ref * torch.pow(10.0, x * power / 10.0)


class SpectralTransform:
    """The MDCT/IMDCT matrices on one device plus the normalization config.
    ``device`` defaults to the card and raises without CUDA
    (``device.resolve_device``); only an explicit ``"cpu"`` runs there.
    ``fused`` says which form serves the configuration (module docstring)."""

    def __init__(self, cfg: SpectralConfig, device="cuda", dtype=torch.float32):
        device = resolve_device(device)
        self.cfg, self.device, self.dtype = cfg, device, dtype
        self.fused = fused_compatible(cfg, dtype, device)
        self.mdct = MDCT(cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.center,
                         device, dtype)
        self.imdct = IMDCT(cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.center,
                           device, dtype)
        # K1's and K2's operands where they serve (win = n_fft)
        self.spectro_mat, self.synth_mat = self.mdct.kernel, self.imdct.kernel

    def with_matrices(self, spectro_mat: torch.Tensor,
                      synth_mat: torch.Tensor) -> "SpectralTransform":
        """A copy of this transform that reads ``spectro_mat`` and
        ``synth_mat`` (a module's buffers: ``train/step.py``
        ``InferenceModule``) in both forms."""
        out = copy.copy(self)
        out.mdct, out.imdct = copy.copy(self.mdct), copy.copy(self.imdct)
        out.mdct.kernel = out.spectro_mat = spectro_mat
        out.imdct.kernel = out.synth_mat = synth_mat
        return out

    def norm_param(self) -> Dict[str, float]:
        """The fixed bounds of ``abs_norm``."""
        return {"min": float(self.cfg.src_range[0]), "max": float(self.cfg.src_range[1])}

    def _fused_affine(self) -> Tuple[float, float]:
        """``normalize`` collapsed to one affine after the arcsinh, taking
        ``src_range`` onto ``norm_range`` (constants under ``abs_norm``)."""
        (lo, hi), (r0, r1) = self.cfg.src_range, self.cfg.norm_range
        scale = (r1 - r0) / (hi - lo)
        return scale, r0 - lo * scale

    def _fused_inverse_affine(self) -> Tuple[float, float]:
        """(scale, shift) taking ``norm_range`` back onto ``src_range``."""
        (lo, hi), (r0, r1) = self.cfg.src_range, self.cfg.norm_range
        scale = (hi - lo) / (r1 - r0)
        return scale, lo - r0 * scale

    # -------------------------------------------------------------- #
    # normalize / denormalize
    # -------------------------------------------------------------- #
    def normalize(self, spectro: torch.Tensor) -> Tuple[torch.Tensor, NormParam]:
        """(B, 1, F, K) spectrum -> (normalized (B, C, F, K), bounds); C is 2
        under ``explicit_encoding``, else 1."""
        cfg = self.cfg
        if cfg.explicit_encoding:
            neg = 0.5 * (torch.abs(spectro) - spectro)
            pos = spectro + neg
            log_spectro = torch.cat((
                amplitude_to_db(cfg.alpha * pos + (1 - cfg.alpha) * neg, cfg.min_value),
                amplitude_to_db((1 - cfg.alpha) * pos + cfg.alpha * neg, cfg.min_value),
            ), dim=1)
        elif cfg.arcsinh_transform:
            log_spectro = torch.asinh(cfg.arcsinh_gain * spectro) / _LN10
        elif cfg.raw_mdct:
            log_spectro = spectro
        else:
            log_spectro = amplitude_to_db(torch.abs(spectro) + cfg.min_value, cfg.min_value)
        if cfg.abs_norm:
            lo, hi = self.norm_param()["min"], self.norm_param()["max"]
        else:
            hi = torch.amax(log_spectro, dim=(-2, -1), keepdim=True)
            lo = torch.amin(log_spectro, dim=(-2, -1), keepdim=True)
        out = (log_spectro - lo) / (hi - lo)
        out = out * (cfg.norm_range[1] - cfg.norm_range[0]) + cfg.norm_range[0]
        return out, {"min": lo, "max": hi}

    def denormalize(self, log_spectro: torch.Tensor, lo, hi) -> torch.Tensor:
        """The inverse of ``normalize`` with bounds ``lo``, ``hi`` (floats or
        tensors); the explicit mode goes through the dB inverse, as the
        reference does."""
        cfg = self.cfg
        x = (log_spectro - cfg.norm_range[0]) / (cfg.norm_range[1] - cfg.norm_range[0])
        x = x * (hi - lo) + lo
        if cfg.arcsinh_transform:
            return torch.sinh(x * _LN10) / cfg.arcsinh_gain
        if cfg.raw_mdct:
            return x
        return db_to_amplitude(x) - cfg.min_value

    # -------------------------------------------------------------- #
    # waveform <-> normalized spectro image
    # -------------------------------------------------------------- #
    def to_spectro(
        self,
        audio: torch.Tensor,
        mask: bool = False,
        mask_size: int = -1,
        generator: Optional[torch.Generator] = None,
        rows: Rows = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], NormParam]:
        """(B, T) waveform -> (normalized (B, C, F, K) spectro, pha, bounds).

        One K1 launch on a CUDA tensor where ``fused``, else the matmul
        form.  ``pha`` is the spectrum's sign, which only ``to_audio``'s dB
        path reads; every other mode returns None.  The JAX package's
        noise jitter on ``pha`` is left out: no caller consumes a jittered
        ``pha`` (the train step discards it, and inference draws none).
        ``mask`` replaces the top ``mask_size`` columns (``lr_mask_size``
        at -1) with zeros, or, with a ``generator`` and without
        ``fit_residual``, with normal noise divided by its range; ``rows``
        draws it at the global batch's shape (module docstring)."""
        cfg = self.cfg
        pha = None
        if self.fused:
            log_spectro = mdct_kernels.mdct_spectro(
                audio, self.spectro_mat, cfg.arcsinh_gain, *self._fused_affine(),
                hop_length=cfg.hop_length, win_length=cfg.win_length)[:, None]
            norm_param: NormParam = self.norm_param()
        else:
            spectro = self.mdct(audio)[:, None]
            if not (cfg.explicit_encoding or cfg.arcsinh_transform or cfg.raw_mdct):
                pha = torch.sign(spectro)
            log_spectro, norm_param = self.normalize(spectro)
        if mask:
            if mask_size == -1:
                mask_size = cfg.lr_mask_size
            if mask_size > 0:
                keep = log_spectro[..., :-mask_size]
                shape = (*log_spectro.shape[:-1], mask_size)
                if cfg.fit_residual or generator is None:
                    fill = log_spectro.new_zeros(shape)
                else:
                    # drawn where the generator lives, into pinned memory
                    # for the card, so the copy does not stop the host
                    fill = torch.randn(_draw_shape(shape, rows), generator=generator,
                                       device=generator.device, dtype=log_spectro.dtype,
                                       pin_memory=log_spectro.is_cuda
                                       and generator.device.type == "cpu")
                    fill = fill.to(log_spectro.device, non_blocking=True)
                    fill = _own_rows(fill / (fill.max() - fill.min()), rows, shape[0])
                log_spectro = torch.cat((keep, fill), dim=-1)
        return log_spectro, pha, norm_param

    def lr_forward(self, lr_audio: torch.Tensor,
                   generator: Optional[torch.Generator] = None, rows: Rows = None):
        """The LR branch: ``to_spectro`` masked by ``cfg.mask``."""
        return self.to_spectro(lr_audio, mask=self.cfg.mask, generator=generator, rows=rows)

    def hr_forward(self, hr_audio: torch.Tensor,
                   generator: Optional[torch.Generator] = None, rows: Rows = None):
        """The HR branch: ``to_spectro`` masked by ``cfg.mask_hr`` at
        ``hr_mask_size``."""
        return self.to_spectro(hr_audio, mask=self.cfg.mask_hr,
                               mask_size=self.cfg.hr_mask_size, generator=generator,
                               rows=rows)

    def draws(self) -> bool:
        """Whether ``lr_forward`` or ``hr_forward`` draws from a generator
        given to it: a masked branch with columns to mask, without
        ``fit_residual`` (``to_spectro``)."""
        cfg = self.cfg
        hr_size = cfg.lr_mask_size if cfg.hr_mask_size == -1 else cfg.hr_mask_size
        return not cfg.fit_residual and (
            (cfg.mask and cfg.lr_mask_size > 0) or (cfg.mask_hr and hr_size > 0))

    def to_audio(
        self,
        log_spectro: torch.Tensor,
        norm_param: NormParam,
        pha: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        out_length: Optional[int] = None,
        rows: Rows = None,
    ) -> torch.Tensor:
        """(B, C, F, K) normalized spectro -> waveform, denormalized with
        ``norm_param``.  One K2 launch on a CUDA tensor where ``fused``
        (the bounds are then ``src_range``'s), else the matmul form.

        The explicit mode recombines its channels as ``(s0 - s1)/(2 alpha -
        1)``.  The dB mode multiplies by ``pha`` (the LR sign) on the first
        ``F/up_ratio`` rows and by a pseudo-phase of +-1 on the rest, drawn
        from ``generator`` (ones without one), when ``up_ratio > 1``;
        ``rows`` draws it at the global batch's shape (module docstring)."""
        cfg = self.cfg
        if self.fused:
            audio = mdct_kernels.imdct_audio(
                log_spectro[:, 0], self.synth_mat, cfg.arcsinh_gain,
                *self._fused_inverse_affine(),
                hop_length=cfg.hop_length, win_length=cfg.win_length)
        else:
            spectro = self.denormalize(log_spectro, norm_param["min"], norm_param["max"])
            if cfg.explicit_encoding:
                spectro = (spectro[:, 0] - spectro[:, 1]) / (2 * cfg.alpha - 1)
            elif cfg.arcsinh_transform or cfg.raw_mdct:
                spectro = spectro[:, 0]
            else:
                spectro, pha = spectro[:, 0], pha[:, 0]
                if cfg.up_ratio > 1:
                    lr_rows = int(pha.shape[-2] * (1 / cfg.up_ratio))
                    if generator is None:
                        pseudo = torch.ones_like(pha)
                    else:
                        bits = _own_rows(torch.randint(
                            0, 2, _draw_shape(pha.shape, rows), generator=generator,
                            device=generator.device), rows, pha.shape[0])
                        pseudo = (2 * bits - 1).to(pha.device, pha.dtype)
                    pha = torch.cat((pha[..., :lr_rows, :], pseudo[..., lr_rows:, :]), dim=-2)
                    spectro = spectro * pha
            audio = self.imdct(spectro)
        if out_length is not None:
            audio = audio[..., :out_length]
        return audio

    def abs_channel(self, log_spectro: torch.Tensor) -> torch.Tensor:
        """Second "abs" input channel (--abs_spectro with arcsinh):
        |x|*2 + norm_range[0]."""
        return torch.abs(log_spectro) * 2 + self.cfg.norm_range[0]

    def g_input(self, log_spectro: torch.Tensor) -> torch.Tensor:
        """The generator's (and the discriminator's image) input: the abs
        channel added under ``abs_spectro`` with arcsinh only."""
        if self.cfg.abs_spectro and self.cfg.arcsinh_transform:
            return torch.cat((log_spectro, self.abs_channel(log_spectro)), dim=1)
        return log_spectro
