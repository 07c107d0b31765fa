"""Canonical configurations, as options dicts.

``flagship_opt()`` is the configuration of record of ``train.sh`` /
``generate_audio.sh``: 16 -> 48 kHz, n_fft 512 / hop 256 / segment 32512
(a 128 x 256 spectrum), arcsinh gain 1000, abs_norm [-5, 5] -> [-1, 1],
``netG local`` ngf 56 with 3 global downsamples, 4 global resblocks and 3
attention blocks (6 heads x 128), 3 local resblocks, resconv down,
interpolate up, fit_residual.
"""

from __future__ import annotations

from typing import Dict


def flagship_opt() -> Dict:
    return dict(
        n_fft=512, hop_length=256, win_length=512, center=True, bins=128,
        lr_sampling_rate=16000, hr_sampling_rate=48000, sr_sampling_rate=48000,
        segment_length=32512,
        arcsinh_transform=True, arcsinh_gain=1000.0, abs_norm=True,
        src_range=(-5.0, 5.0), norm_range=(-1.0, 1.0),
        fit_residual=True, abs_spectro=True,
        netG="local", input_nc=2, output_nc=1, ngf=56,
        n_downsample_global=3, n_blocks_global=4, n_blocks_attn_g=3,
        proj_factor_g=4, heads_g=6, dim_head_g=128,
        n_local_enhancers=1, n_blocks_local=3, n_blocks_attn_l=0,
        downsample_type="resconv", upsample_type="interpolate",
    )
