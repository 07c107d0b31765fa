"""Canonical configurations, as options dicts.

``flagship_opt()`` is the configuration of record of ``train.sh`` /
``generate_audio.sh``: 16 -> 48 kHz, n_fft 512 / hop 256 / segment 32512
(a 128 x 256 spectrum), arcsinh gain 1000, abs_norm [-5, 5] -> [-1, 1],
``netG local`` ngf 56 with 3 global downsamples, 4 global resblocks and 3
attention blocks (6 heads x 128), 3 local resblocks, resconv down,
interpolate up, fit_residual; the multiscale discriminator of ndf 64 with
3 layers at 3 scales; and the optimizer of ``train.sh``: Adam at lr 1.5e-4,
beta1 0.5, 60 epochs constant and 60 decaying (``train.sh`` trains at
batch 20).  ``train.sh`` and ``generate_audio.sh`` also set ``--fp16``,
the bf16 policy; this dict leaves it out, so the flagship built from it
computes in float32, and a caller adds ``fp16=True`` for bf16.

``tiny_opt()`` is the JAX package's tiny configuration
(``mdctgan_tpu/configs.py`` ``tiny_spectral``/``tiny_generator``/
``tiny_discriminator``) for tests and dry runs: n_fft 64 / hop 32 /
segment 992 (a 32 x 32 spectrum), ``netG global`` ngf 4 with 2 downsamples,
one resblock and one attention block (2 heads x 4), and the 2-scale
discriminator of ndf 4 with 2 layers.
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
        ndf=64, n_layers_D=3, num_D=3,
        lr=1.5e-4, beta1=0.5, niter=60, niter_decay=60,
    )


def tiny_opt() -> Dict:
    return dict(
        n_fft=64, hop_length=32, win_length=64, center=True, bins=32,
        lr_sampling_rate=16000, hr_sampling_rate=48000, sr_sampling_rate=48000,
        segment_length=992,
        arcsinh_transform=True, arcsinh_gain=1000.0, abs_norm=True,
        src_range=(-5.0, 5.0), norm_range=(-1.0, 1.0),
        fit_residual=True, abs_spectro=True,
        netG="global", input_nc=2, output_nc=1, ngf=4,
        n_downsample_global=2, n_blocks_global=1, n_blocks_attn_g=1,
        proj_factor_g=4, heads_g=2, dim_head_g=4,
        downsample_type="resconv", upsample_type="interpolate",
        ndf=4, n_layers_D=2, num_D=2,
    )
