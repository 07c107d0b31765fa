"""Options dict -> spectral configuration and train options.

The port takes its options as a plain dict whose keys are the reference CLI
flags (``vars()`` of a parsed reference namespace works as it is).  A
spectral key that is absent takes the ``SpectralConfig`` default, which is
the flagship transform; a train key that is absent takes the default of the
reference's train options.
"""

from __future__ import annotations

from typing import Dict, Mapping

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


# The train keys and their defaults (the JAX package's ``TrainOptions``).
TRAIN_DEFAULTS = dict(
    lr=0.0002, beta1=0.5, niter=100, niter_decay=100, niter_fix_global=0,
    ndf=64, n_layers_D=3, num_D=2, lambda_feat=10.0, no_lsgan=False,
    no_ganFeat_loss=False, pool_size=0, freeze_g_d=False, freeze_g_u=False,
    freeze_l_d=False, freeze_l_u=False, fp16=False, accum_steps=1,
)


def train_options(opt: Mapping) -> Dict:
    """The train keys of ``opt``, with defaults.  Raises
    ``NotImplementedError`` for what the port does not train yet: the bf16
    policy (``fp16``) and gradient accumulation (``accum_steps > 1``)."""
    out = {k: opt.get(k, v) for k, v in TRAIN_DEFAULTS.items()}
    if out["fp16"]:
        raise NotImplementedError("the bf16 policy (fp16) is not ported")
    if int(out["accum_steps"]) > 1:
        raise NotImplementedError("gradient accumulation (accum_steps > 1) is not ported")
    return out
