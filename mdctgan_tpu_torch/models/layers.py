"""Building-block layers (NCHW shapes; channels-last bytes under ``conv_nhwc``).

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

Every tensor has the logical NCHW shape.  Where ``conv_nhwc`` says so (bf16
on the card) the networks hold their activations channels-last
(``conv_layout`` at each network's entry): the same shapes and numbers, NHWC
strides, which cuDNN's bf16 kernels read and write without a transpose.
The ops between the convolutions keep that layout (``reflect_pad`` by a
form of its own).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mdctgan_tpu_torch.utils import tracing

_EPS = 1e-5


def lift(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or kept in float64: the casts back out of the
    compute dtype."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``nn.ReflectionPad2d(pad)`` on the two spatial axes.  A channels-last
    ``x`` keeps its layout (the card's 2-D reflection pad returns NCHW):
    its (N, H, W, C) bytes, as an unbatched 3-D volume, are padded on H and
    W and not on C, the same elements as the 2-D pad."""
    if not channels_last(x):
        return F.pad(x, (pad, pad, pad, pad), mode="reflect")
    nhwc = F.pad(x.permute(0, 2, 3, 1), (0, 0, pad, pad, pad, pad), mode="reflect")
    return nhwc.permute(0, 3, 1, 2)


def channels_last(x: torch.Tensor) -> bool:
    """Whether ``x`` is a 4-D tensor laid out channels-last and not also
    contiguous (one channel, or one pixel, is both)."""
    return (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


class _BroadcastMean(torch.autograd.Function):
    """``x.mean(dim, keepdim, dtype=dtype)`` whose gradient returns
    broadcast: divided and cast to ``x``'s dtype at the mean's shape, then
    expanded, the values autograd's own gives.  Autograd's expands first
    and materializes the division and the cast at ``x``'s shape in NCHW,
    which meets a channels-last gradient in the next op: a transposing
    pass over the map."""

    @staticmethod
    def forward(ctx, x, dim, keepdim, dtype):
        ctx.shape, ctx.dtype, ctx.dim, ctx.keepdim = x.shape, x.dtype, dim, keepdim
        return x.mean(dim=dim, keepdim=keepdim, dtype=dtype)

    @staticmethod
    def backward(ctx, grad):
        rank = len(ctx.shape)
        dims = range(rank) if ctx.dim is None else sorted(d % rank for d in ctx.dim)
        if not ctx.keepdim:
            for d in dims:
                grad = grad.unsqueeze(d)
        n = math.prod(ctx.shape[d] for d in dims)
        return (grad / n).to(ctx.dtype).expand(ctx.shape), None, None, None


def reduce_mean(x: torch.Tensor, dim: Optional[Sequence[int]] = None, keepdim: bool = False,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x.mean(dim, keepdim, dtype=dtype)`` (every axis where ``dim`` is
    None); on a channels-last ``x`` that autograd records, its gradient
    stays channels-last (``_BroadcastMean``)."""
    if channels_last(x) and x.requires_grad and torch.is_grad_enabled():
        return _BroadcastMean.apply(x, None if dim is None else tuple(dim), keepdim, dtype)
    if dim is None:
        return x.mean(dtype=dtype)
    return x.mean(dim=dim, keepdim=keepdim, dtype=dtype)


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm2d(affine=False): per (sample, channel) over H, W, with
    the two-pass biased variance and eps 1e-5.  A bf16 ``x`` stays bf16, as
    in ``mdctgan_tpu/ops/norm.py``: both means accumulate in float32, the
    mean and the inverse deviation are rounded to bf16, and the centring,
    the square and the scaling run in bf16."""
    acc = torch.promote_types(x.dtype, torch.float32)
    centered = x - reduce_mean(x, (2, 3), keepdim=True, dtype=acc).to(x.dtype)
    var = reduce_mean(centered.square(), (2, 3), keepdim=True, dtype=acc)
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


# The most rows of a float32 convolution that the card runs in one call.
F32_CONV_ROWS = 8


def f32_conv_rows(dtype: torch.dtype, device: torch.device, batch: int) -> Optional[int]:
    """The rows a convolution of ``batch`` rows of ``dtype`` operands on
    ``device`` runs at a time, or None for the whole batch in one call.

    Past 8 rows, cuDNN's heuristic takes many float32 convolutions on the
    H100 (TF32 off) to FFT-tiled algorithms, which cost up to 10x as much a
    row as the same convolution at 8 rows and hold gigabytes of workspace;
    the autotuner and channels-last do not avoid them.  The flagship
    generator's forward takes 190 ms at batch 16 and 397 ms at 20 on the
    whole batch, 77 and 96 ms in slices of 8.  So a float32 batch of more
    than 8 rows on the card runs in slices of 8, each an ordinary cuDNN
    call.  bf16 operands (cuDNN picks no FFT-tiled bf16 algorithm) and the
    CPU keep the whole batch."""
    if dtype == torch.float32 and device.type == "cuda" and batch > F32_CONV_ROWS:
        return F32_CONV_ROWS
    return None


def conv_nhwc(dtype: Optional[torch.dtype], device: torch.device) -> bool:
    """Whether the convolutions of a network computing in ``dtype`` on
    ``device`` run on channels-last activations.

    cuDNN's bf16 tensor-core kernels on the H100 are NHWC: given NCHW
    operands, it transposes every convolution's input in and its output
    back out (``nchwToNhwcKernel``, ``nhwcToNchwKernel``), in the forward
    and in both halves of the backward, 12-15% of the batch-20 bf16 train
    step's card time.  So a bf16 network on the card holds its activations
    channels-last.  float32 operands (SIMT kernels with TF32 off, NCHW
    natives, which channels-last does not speed up), ``None`` (the plain
    float32 module) and the CPU keep NCHW."""
    return dtype == torch.bfloat16 and device.type == "cuda"


def conv_layout(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` in the layout the convolutions of a network computing in
    ``dtype`` run in (``conv_nhwc``): the networks' entry."""
    if conv_nhwc(dtype, x.device):
        return x.contiguous(memory_format=torch.channels_last)
    return x


class _ChannelsLastWeight(torch.autograd.Function):
    """A contiguous weight cast to ``dtype`` channels-last, in one pass; its
    gradient returns contiguous in the weight's dtype, so that it reaches
    the optimizer in the layout of its parameter (a mismatch takes
    ``torch._foreach_*`` off its multi-tensor path)."""

    @staticmethod
    def forward(ctx, w, dtype):
        ctx.dtype = w.dtype
        return w.to(dtype, memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype, memory_format=torch.contiguous_format), None


def conv_forward(conv: nn.Module, x: torch.Tensor,
                 dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``conv(x)`` for an ``nn.Conv2d`` or ``nn.ConvTranspose2d`` in the
    compute ``dtype``: ``x``, the weight and the bias cast to it, the output
    in it.  ``None`` runs the module as it is, in slices of rows where
    ``f32_conv_rows`` says so (a convolution treats each row alone, and
    autograd sums the weight's gradient over the slices).

    Flax adds the bias after rounding the product to bf16; here the bias
    goes into the convolution, which may add it before that rounding.  Both
    forms were held against a float64 truth (``tests/test_torch_bf16.py``)
    and the fused one is as close or closer, and saves a pass over every
    output.

    Where ``conv_nhwc`` holds, the input and the weight are cast
    channels-last (the output follows), and the counters
    ``conv.bf16_calls`` and, where ``x`` arrived channels-last,
    ``conv.nhwc_in`` grow by one (``utils/tracing.py``)."""
    if dtype is None:
        rows = f32_conv_rows(x.dtype, x.device, x.shape[0])
        if rows is None:
            return conv(x)
        return torch.cat([conv(part) for part in x.split(rows)])
    if conv_nhwc(dtype, x.device):
        tracing.count("conv.bf16_calls")
        if x.is_contiguous(memory_format=torch.channels_last):
            tracing.count("conv.nhwc_in")
        x = x.to(dtype, memory_format=torch.channels_last)
        w = conv.weight
        # the Function costs the host a call; without autograd the cast is the same
        w = (_ChannelsLastWeight.apply(w, dtype) if w.requires_grad and torch.is_grad_enabled()
             else w.to(dtype, memory_format=torch.channels_last))
    else:
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
