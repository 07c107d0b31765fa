"""Options dict -> spectral configuration.

The port takes its options as a plain dict whose keys are the reference CLI
flags (``vars()`` of a parsed reference namespace works as it is).  A key
that is absent takes the ``SpectralConfig`` default, which is the flagship
transform.
"""

from __future__ import annotations

from typing import Mapping

from mdctgan_tpu_torch.ops.features import SpectralConfig

_SPECTRAL_KEYS = (
    "n_fft", "hop_length", "win_length", "center", "lr_sampling_rate",
    "hr_sampling_rate", "segment_length",
    "arcsinh_transform", "arcsinh_gain", "explicit_encoding", "raw_mdct",
    "abs_norm", "src_range", "norm_range", "mask", "mask_hr", "fit_residual",
    "abs_spectro",
)


def spectral_config_from_opt(opt: Mapping) -> SpectralConfig:
    fields = {k: opt[k] for k in _SPECTRAL_KEYS if k in opt}
    for k in ("src_range", "norm_range"):
        if k in fields:
            fields[k] = tuple(float(v) for v in fields[k])
    return SpectralConfig(**fields)
