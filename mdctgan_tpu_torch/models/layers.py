"""Building-block layers (NCHW).

The port of ``mdctgan_tpu/models/layers.py`` in the reference's own form:
the upsample is nearest 2x followed by the convolution, and the 7x7 output
head is a plain convolution.  The JAX package's dilated, polyphase and phase
forms compute the same math restructured for the TPU and are not carried
over.

Module and parameter names follow the Flax tree (``conv1.conv.weight`` for
Flax ``conv1/conv/kernel``), so ``weights.state_dict_from_jax`` is a rename
plus a transpose.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

_EPS = 1e-5


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``nn.ReflectionPad2d(pad)`` on the two spatial axes."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm2d(affine=False): per (sample, channel) over H, W, with
    the two-pass biased variance and eps 1e-5."""
    centered = x - x.mean(dim=(2, 3), keepdim=True)
    var = centered.square().mean(dim=(2, 3), keepdim=True)
    return centered * torch.rsqrt(var + _EPS)


def instance_norm_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(instance_norm(x))


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False)."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Conv(nn.Module):
    """Conv2d with symmetric zero padding, held as child ``conv`` (the Flax
    ``Conv`` wrapper's scope)."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel, stride, padding,
                              bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ResnetBlock(nn.Module):
    """x + IN(conv(pad(relu(IN(conv(pad(x))))))) with reflect padding."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = Conv(dim, dim, 3)
        self.conv2 = Conv(dim, dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = instance_norm_relu(self.conv1(reflect_pad(x, 1)))
        h = instance_norm(self.conv2(reflect_pad(h, 1)))
        return x + h


class ConvResBlock(nn.Module):
    """Downsample block: strided conv -> {5x5 conv, 3x3 residual conv} ->
    sum."""

    def __init__(self, in_features: int, out_features: int, kernel: int = 3,
                 stride: int = 2, padding: int = 1):
        super().__init__()
        self.conv1 = Conv(in_features, in_features, kernel, stride, padding)
        self.conv_res = Conv(in_features, out_features, 3, 1, 1)
        self.conv2 = Conv(in_features, out_features, 5, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        return self.conv2(x) + self.conv_res(x)


class InterpolateUpsample(nn.Module):
    """Nearest 2x, then a 5x5 pad-1 conv (shrinks by 2) and a 3x3 pad-2 conv
    (grows by 2), plus a 3x3 pad-1 residual conv of the upsampled input."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.conv_res = Conv(in_features, out_features, 3, 1, 1)
        self.conv1 = Conv(in_features, out_features, 5, 1, 1)
        self.conv2 = Conv(out_features, out_features, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = upsample_nearest_2x(x)
        return self.conv2(self.conv1(up)) + self.conv_res(up)
