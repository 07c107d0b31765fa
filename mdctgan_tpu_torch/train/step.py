"""The serving forward (the inference half of ``mdctgan_tpu/train/step.py``).

The train step (discriminator, losses, masked BatchNorm statistics, Adam)
belongs to a later part of the port.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn

from mdctgan_tpu_torch.device import float32_policy
from mdctgan_tpu_torch.ops.features import SpectralTransform


def build_inference_fn(
    generator: nn.Module,
    transform: SpectralTransform,
    out_length: Optional[int] = None,
) -> Callable:
    """LR waveform segments (B, T) -> (SR spectro (B, 1, F, K), SR waveform
    (B, out_length)).

    The LR spectrum (one K1 launch) gets its abs channel and goes through the
    generator; under fit_residual the LR band of the output is scaled by 1e-3
    and the LR spectrum added; the result is denormalized with the *LR*
    normalisation parameters and synthesised (one K2 launch)."""
    cfg = transform.cfg

    @torch.inference_mode()
    @float32_policy()
    def infer(lr_audio: torch.Tensor):
        lr_spec, lr_np = transform.to_spectro(lr_audio)
        sr = generator(transform.g_input(lr_spec))
        if cfg.fit_residual:
            lr_part = int(sr.shape[-1] / cfg.up_ratio)
            sr[..., :lr_part] *= 1e-3
            sr = sr + lr_spec
        sr_audio = transform.to_audio(sr, lr_np, out_length=out_length)
        return sr, sr_audio

    return infer
