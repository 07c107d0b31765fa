"""The generator and the discriminator in float32 (NCHW), under the port's
parameter names so that one state dict loads into both.

Generator (``netG local``, one enhancer, or ``netG global``): a 7x7 stem,
``resconv`` strided stages, resblocks with a BottleStack of multi-head
self-attention (absolute 2-D position embedding, BatchNorm) in the middle,
``interpolate`` upsamples (nearest 2x, 5x5 pad 1, 3x3 pad 2, plus a 3x3
residual) and a 7x7 tanh head; the LocalEnhancer runs the headless global
generator on the average-pooled input and adds it into its own branch.
Discriminator: ``num_D`` PatchGANs of 4x4 convolutions (padding 2) over an
average-pool pyramid, each returning its intermediate features.

Every convolution reads its operands through ``prec.cast``
(``precision.py``): the identity for the reference, float8 for the control.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.precision import FLOAT32, Precision

EPS = 1e-5


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    centred = x - x.mean(dim=(2, 3), keepdim=True)
    return centred * torch.rsqrt(centred.square().mean(dim=(2, 3), keepdim=True) + EPS)


def in_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(instance_norm(x))


def reflect(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def avg_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)


class Conv(nn.Module):
    """``conv.weight`` / ``conv.bias`` of a 2-D convolution."""

    def __init__(self, cin, cout, k, stride=1, pad=0, bias=True, prec=FLOAT32):
        super().__init__()
        self.stride, self.pad, self.prec = stride, pad, prec
        self.conv = nn.Conv2d(cin, cout, k, stride, pad, bias=bias)

    def forward(self, x):
        c = self.prec.cast
        return F.conv2d(c(x), c(self.conv.weight), self.conv.bias, self.stride, self.pad)


def conv1x1(conv: nn.Conv2d, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return F.conv2d(prec.cast(x), prec.cast(conv.weight))


class ResnetBlock(nn.Module):
    def __init__(self, dim, prec):
        super().__init__()
        self.conv1, self.conv2 = Conv(dim, dim, 3, prec=prec), Conv(dim, dim, 3, prec=prec)

    def forward(self, x):
        h = in_relu(self.conv1(reflect(x, 1)))
        return x + instance_norm(self.conv2(reflect(h, 1)))


class ConvResBlock(nn.Module):
    """The ``resconv`` downsample: 3x3 stride 2, then 5x5 plus a 3x3
    residual."""

    def __init__(self, cin, cout, prec):
        super().__init__()
        self.conv1 = Conv(cin, cin, 3, 2, 1, prec=prec)
        self.conv_res = Conv(cin, cout, 3, 1, 1, prec=prec)
        self.conv2 = Conv(cin, cout, 5, 1, 2, prec=prec)

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(x) + self.conv_res(x)


class InterpolateUpsample(nn.Module):
    def __init__(self, cin, cout, prec):
        super().__init__()
        self.conv_res = Conv(cin, cout, 3, 1, 1, prec=prec)
        self.conv1 = Conv(cin, cout, 5, 1, 1, prec=prec)
        self.conv2 = Conv(cout, cout, 3, 1, 2, prec=prec)

    def forward(self, x):
        up = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv2(self.conv1(up)) + self.conv_res(up)


class BN(nn.Module):
    """BatchNorm (eps 1e-5, momentum 0.1) as ``bn.weight``/``bn.bias`` with
    running statistics ``bn.running_mean``/``bn.running_var``: in train
    mode the batch statistics (biased, two-pass), which the running ones
    follow (the variance Bessel-corrected); running ones in eval mode."""

    def __init__(self, channels):
        super().__init__()
        self.bn = nn.Module()
        self.bn.weight = nn.Parameter(torch.ones(channels))
        self.bn.bias = nn.Parameter(torch.zeros(channels))
        self.bn.register_buffer("running_mean", torch.zeros(channels))
        self.bn.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        bn = self.bn
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean[:, None, None]).square().mean(dim=(0, 2, 3))
            n = x.numel() / x.shape[1]
            with torch.no_grad():
                bn.running_mean.mul_(0.9).add_(0.1 * mean)
                bn.running_var.mul_(0.9).add_(0.1 * n / max(n - 1.0, 1.0) * var)
        else:
            mean, var = bn.running_mean, bn.running_var
        mul = torch.rsqrt(var + EPS) * bn.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]


class PosEmb(nn.Module):
    def __init__(self, fmap: Tuple[int, int], dim_head: int):
        super().__init__()
        self.height = nn.Parameter(torch.zeros(fmap[0], dim_head))
        self.width = nn.Parameter(torch.zeros(fmap[1], dim_head))


class Attention(nn.Module):
    """Multi-head self-attention over the (H W) tokens of a map; the qkv
    channels split as (3, heads, dim_head), the output returns as (heads,
    dim_head)."""

    def __init__(self, dim, fmap, heads, dim_head, prec):
        super().__init__()
        self.heads, self.dim_head, self.prec = heads, dim_head, prec
        self.to_qkv = nn.Conv2d(dim, 3 * heads * dim_head, 1, bias=False)
        self.pos_emb = PosEmb(fmap, dim_head)

    def forward(self, x):
        b, _, h, w = x.shape
        heads, dh = self.heads, self.dim_head
        qkv = conv1x1(self.to_qkv, x, self.prec).reshape(b, 3, heads, dh, h * w)
        q, k, v = (qkv[:, i].transpose(-1, -2) for i in range(3))
        q = q * dh ** -0.5
        pe = self.pos_emb
        emb = (pe.height[:, None, :] + pe.width[None, :, :]).reshape(-1, dh)
        attn = torch.softmax(q @ k.transpose(-1, -2) + q @ emb.t(), dim=-1)
        return (attn @ v).transpose(-1, -2).reshape(b, heads * dh, h, w)


class BottleBlock(nn.Module):
    def __init__(self, dim, dim_out, fmap, proj_factor, heads, dim_head, prec):
        super().__init__()
        self.prec = prec
        self.has_shortcut = dim != dim_out
        if self.has_shortcut:
            self.shortcut_conv = nn.Conv2d(dim, dim_out, 1, bias=False)
            self.shortcut_bn = BN(dim_out)
        inner, attn_in = heads * dim_head, dim_out // proj_factor
        self.proj_in = nn.Conv2d(dim, attn_in, 1, bias=False)
        self.bn1 = BN(attn_in)
        self.attn = Attention(attn_in, fmap, heads, dim_head, prec)
        self.bn2 = BN(inner)
        self.proj_out = nn.Conv2d(inner, dim_out, 1, bias=False)
        self.bn3 = BN(dim_out)

    def forward(self, x):
        p = self.prec
        short = x
        if self.has_shortcut:
            short = torch.relu(self.shortcut_bn(conv1x1(self.shortcut_conv, x, p)))
        h = torch.relu(self.bn1(conv1x1(self.proj_in, x, p)))
        h = torch.relu(self.bn2(self.attn(h)))
        return torch.relu(self.bn3(conv1x1(self.proj_out, h, p)) + short)


class GlobalGenerator(nn.Module):
    def __init__(self, input_nc, output_nc, ngf, n_down, n_blocks, n_attn, input_size,
                 proj_factor, heads, dim_head, include_head, prec):
        super().__init__()
        self.n_down, self.n_blocks, self.include_head = n_down, n_blocks, include_head
        self.stem = Conv(input_nc, ngf, 7, prec=prec)
        for i in range(n_down):
            self.add_module(f"down{i}", ConvResBlock(ngf * 2 ** i, ngf * 2 ** (i + 1), prec))
        mult = 2 ** n_down
        self.attn = None
        if n_attn:
            fmap = (input_size[0] // mult, input_size[1] // mult)
            self.attn = nn.Module()  # the port's names: attn.block{i}
            for i in range(n_attn):
                self.attn.add_module(f"block{i}", BottleBlock(
                    ngf * mult, ngf * mult, fmap, proj_factor, heads, dim_head, prec))
        for i in range(n_blocks):
            self.add_module(f"res{i}", ResnetBlock(ngf * mult, prec))
        for i in range(n_down):
            m = 2 ** (n_down - i)
            self.add_module(f"up{i}", InterpolateUpsample(ngf * m, ngf * m // 2, prec))
        if include_head:
            self.head = Conv(ngf, output_nc, 7, prec=prec)

    def features(self, x):
        h = in_relu(self.stem(reflect(x, 3)))
        for i in range(self.n_down):
            h = in_relu(getattr(self, f"down{i}")(h))
        for i in range(self.n_blocks):
            if i == self.n_blocks // 2 and self.attn is not None:
                for block in self.attn.children():
                    h = block(h)
            h = getattr(self, f"res{i}")(h)
        for i in range(self.n_down):
            h = in_relu(getattr(self, f"up{i}")(h))
        return h

    def forward(self, x):
        h = self.features(x)
        return torch.tanh(self.head(reflect(h, 3))) if self.include_head else h


class LocalEnhancer(nn.Module):
    """One enhancer branch around a headless global generator of twice the
    width on the pooled input."""

    def __init__(self, opt, prec):
        super().__init__()
        g = opt.get
        ngf, size = g("ngf"), (g("bins"), g("n_fft") // 2)
        self.n_blocks_local = g("n_blocks_local")
        self.add_module("global", GlobalGenerator(
            g("input_nc"), g("output_nc"), ngf * 2, g("n_downsample_global"),
            g("n_blocks_global"), g("n_blocks_attn_g"), (size[0] // 2, size[1] // 2),
            g("proj_factor_g"), g("heads_g"), g("dim_head_g"), False, prec))
        self.local_stem = Conv(g("input_nc"), ngf, 7, prec=prec)
        self.local_down = ConvResBlock(ngf, ngf * 2, prec)
        for i in range(self.n_blocks_local):
            self.add_module(f"local_res{i}", ResnetBlock(ngf * 2, prec))
        self.local_up = InterpolateUpsample(ngf * 2, ngf, prec)
        self.local_head = Conv(ngf, g("output_nc"), 7, prec=prec)

    def forward(self, x):
        coarse = self._modules["global"](avg_pool(x))
        h = in_relu(self.local_stem(reflect(x, 3)))
        h = in_relu(self.local_down(h)) + coarse
        for i in range(self.n_blocks_local):
            h = getattr(self, f"local_res{i}")(h)
        h = in_relu(self.local_up(h))
        return torch.tanh(self.local_head(reflect(h, 3)))


def build_generator(opt, prec: Precision = FLOAT32) -> nn.Module:
    """The generator of an options dict: ``netG`` local (one enhancer, no
    local attention) or global, ``resconv`` down, ``interpolate`` up."""
    g = opt.get
    if g("downsample_type") != "resconv" or g("upsample_type") != "interpolate":
        raise NotImplementedError("the reference builds resconv down, interpolate up")
    if g("netG") == "local":
        if g("n_local_enhancers", 1) != 1 or g("n_blocks_attn_l", 0):
            raise NotImplementedError("the reference builds one enhancer, no local attention")
        return LocalEnhancer(opt, prec)
    if g("netG") == "global":
        return GlobalGenerator(
            g("input_nc"), g("output_nc"), g("ngf"), g("n_downsample_global"),
            g("n_blocks_global"), g("n_blocks_attn_g"), (g("bins"), g("n_fft") // 2),
            g("proj_factor_g"), g("heads_g"), g("dim_head_g"), True, prec)
    raise NotImplementedError(f"netG {g('netG')}")


class PatchGAN(nn.Module):
    def __init__(self, input_nc, ndf, n_layers, prec):
        super().__init__()
        self.n_layers = n_layers
        self.layer0 = Conv(input_nc, ndf, 4, 2, 2, prec=prec)
        nf = ndf
        for n in range(1, n_layers):
            prev, nf = nf, min(nf * 2, 512)
            self.add_module(f"layer{n}", Conv(prev, nf, 4, 2, 2, prec=prec))
        prev, nf = nf, min(nf * 2, 512)
        self.add_module(f"layer{n_layers}", Conv(prev, nf, 4, 1, 2, prec=prec))
        self.add_module(f"layer{n_layers + 1}", Conv(nf, 1, 4, 1, 2, prec=prec))

    def forward(self, x) -> List[torch.Tensor]:
        h = F.leaky_relu(self.layer0(x), 0.2)
        feats = [h]
        for n in range(1, self.n_layers + 1):
            h = F.leaky_relu(instance_norm(getattr(self, f"layer{n}")(h)), 0.2)
            feats.append(h)
        feats.append(getattr(self, f"layer{self.n_layers + 1}")(h))
        return feats


class Discriminator(nn.Module):
    """``num_D`` PatchGANs; the one that sees the input pooled i times is
    ``scale{num_D - 1 - i}``; returns their feature lists, finest first."""

    def __init__(self, opt, prec: Precision = FLOAT32):
        super().__init__()
        g = opt.get
        self.num_d = g("num_D")
        for i in range(self.num_d):
            self.add_module(f"scale{self.num_d - 1 - i}", PatchGAN(
                g("input_nc") + g("output_nc"), g("ndf"), g("n_layers_D"), prec))

    def forward(self, x) -> List[List[torch.Tensor]]:
        out = []
        for i in range(self.num_d):
            out.append(getattr(self, f"scale{self.num_d - 1 - i}")(x))
            if i != self.num_d - 1:
                x = avg_pool(x)
        return out


def g_input(spec: torch.Tensor, norm_low: float) -> torch.Tensor:
    """The generator's input: the spectrum and its abs channel,
    ``2 |x| + norm_range[0]``."""
    return torch.cat((spec, spec.abs() * 2 + norm_low), dim=1)
