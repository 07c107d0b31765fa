"""Building-block layers (NCHW).

The port of ``mdctgan_tpu/models/layers.py`` in the reference's own form:
the interpolate upsample is nearest 2x followed by the convolution, the
transconv upsample is one ``nn.ConvTranspose2d``, and the 7x7 output head is
a plain convolution.  The JAX package's dilated, polyphase and phase
forms compute the same math restructured for the TPU and are not carried
over.

Module and parameter names follow the Flax tree (``conv1.conv.weight`` for
Flax ``conv1/conv/kernel``), so ``weights.state_dict_from_jax`` is a rename
plus a transpose.

``dtype`` is the compute dtype of the JAX package's bf16 policy (``--fp16``):
parameters stay float32; a convolution casts its input, weight and bias to
``dtype`` and returns ``dtype``, as Flax's ``nn.Conv(dtype=)`` does.
``None`` is the plain float32 module.  The instance norm keeps the dtype of
its input and accumulates its statistics in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

_EPS = 1e-5


def lift(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or kept in float64: the casts back out of the
    compute dtype."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``nn.ReflectionPad2d(pad)`` on the two spatial axes."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm2d(affine=False): per (sample, channel) over H, W, with
    the two-pass biased variance and eps 1e-5.  A bf16 ``x`` stays bf16, as
    in ``mdctgan_tpu/ops/norm.py``: both means accumulate in float32, the
    mean and the inverse deviation are rounded to bf16, and the centring,
    the square and the scaling run in bf16."""
    acc = torch.promote_types(x.dtype, torch.float32)
    centered = x - x.mean(dim=(2, 3), keepdim=True, dtype=acc).to(x.dtype)
    var = centered.square().mean(dim=(2, 3), keepdim=True, dtype=acc)
    return centered * torch.rsqrt(var + _EPS).to(x.dtype)


def instance_norm_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(instance_norm(x))


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False)."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def conv_forward(conv: nn.Module, x: torch.Tensor,
                 dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``conv(x)`` for an ``nn.Conv2d`` or ``nn.ConvTranspose2d`` in the
    compute ``dtype``: ``x``, the weight and the bias cast to it, the output
    in it.  ``None`` runs the module as it is.

    Flax adds the bias after rounding the product to bf16; here the bias
    goes into the convolution, which may add it before that rounding.  Both
    forms were held against a float64 truth (``tests/test_torch_bf16.py``)
    and the fused one is as close or closer, and saves a pass over every
    output."""
    if dtype is None:
        return conv(x)
    x, w = x.to(dtype), conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    if isinstance(conv, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, conv.stride, conv.padding, conv.output_padding,
                                  conv.groups, conv.dilation)
    return F.conv2d(x, w, b, conv.stride, conv.padding, conv.dilation, conv.groups)


class Conv(nn.Module):
    """Conv2d with symmetric zero padding, held as child ``conv`` (the Flax
    ``Conv`` wrapper's scope)."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.conv = nn.Conv2d(in_features, features, kernel, stride, padding,
                              bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_forward(self.conv, x, self.compute_dtype)


class ConvTransposed(nn.Module):
    """ConvTranspose2d(k=3, s=2, p=1, output_padding=1), held as child
    ``conv``: doubles H and W.  Its weight is torch's (I, O, kH, kW), which
    the Flax ``transpose_kernel=True`` kernel (kH, kW, O, I) carries to with
    the conv transpose of ``weights.state_dict_from_jax`` and no flip."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.conv = nn.ConvTranspose2d(in_features, features, 3, 2, 1,
                                       output_padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_forward(self.conv, x, self.compute_dtype)


class ResnetBlock(nn.Module):
    """x + IN(conv(pad(relu(IN(conv(pad(x))))))) with reflect padding.  The
    sum promotes: a float32 ``x`` with a bf16 branch stays float32."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(dim, dim, 3, dtype=dtype)
        self.conv2 = Conv(dim, dim, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = instance_norm_relu(self.conv1(reflect_pad(x, 1)))
        h = instance_norm(self.conv2(reflect_pad(h, 1)))
        return x + h


class ConvResBlock(nn.Module):
    """Downsample block: strided conv -> {5x5 conv, 3x3 residual conv} ->
    sum."""

    def __init__(self, in_features: int, out_features: int, kernel: int = 3,
                 stride: int = 2, padding: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(in_features, in_features, kernel, stride, padding, dtype=dtype)
        self.conv_res = Conv(in_features, out_features, 3, 1, 1, dtype=dtype)
        self.conv2 = Conv(in_features, out_features, 5, 1, 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        return self.conv2(x) + self.conv_res(x)


class InterpolateUpsample(nn.Module):
    """Nearest 2x, then a 5x5 pad-1 conv (shrinks by 2) and a 3x3 pad-2 conv
    (grows by 2), plus a 3x3 pad-1 residual conv of the upsampled input."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_res = Conv(in_features, out_features, 3, 1, 1, dtype=dtype)
        self.conv1 = Conv(in_features, out_features, 5, 1, 1, dtype=dtype)
        self.conv2 = Conv(out_features, out_features, 3, 1, 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = upsample_nearest_2x(x)
        return self.conv2(self.conv1(up)) + self.conv_res(up)
