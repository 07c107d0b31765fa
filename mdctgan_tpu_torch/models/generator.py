"""pix2pixHD-style generators (NCHW), inference form.

The port of ``mdctgan_tpu/models/generator.py``.  Submodule names follow the
Flax tree (``global.down0.conv1.conv``, ``local_res2.conv2.conv``, ...);
``global`` is a Python keyword, so that branch is registered with
``add_module`` and reached through ``self.coarse``.

Ported: ``GlobalGenerator`` (with and without its 7x7 tanh head) and
``LocalEnhancer`` with one enhancer branch, with the ``conv``/``resconv``
downsample and the ``interpolate`` upsample.  Not ported yet (they raise
``NotImplementedError``): the ``transconv`` upsample, local attention
(``n_attn_local > 0``) and ``n_local_enhancers > 1``.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn as nn

from mdctgan_tpu_torch.models.attention import BottleStack
from mdctgan_tpu_torch.models.layers import (
    Conv,
    ConvResBlock,
    InterpolateUpsample,
    ResnetBlock,
    avg_pool_3x3_s2,
    instance_norm_relu,
    reflect_pad,
)


def _downsample_layer(kind: str, in_f: int, out_f: int) -> nn.Module:
    if kind == "conv":
        return Conv(in_f, out_f, 3, 2, 1)
    if kind == "resconv":
        return ConvResBlock(in_f, out_f, 3, 2, 1)
    raise NotImplementedError(f"downsample layer [{kind}] is not found")


def _upsample_layer(kind: str, in_f: int, out_f: int) -> nn.Module:
    if kind == "interpolate":
        return InterpolateUpsample(in_f, out_f)
    raise NotImplementedError(f"upsample layer [{kind}] is not ported")


class GlobalGenerator(nn.Module):
    """7x7 stem -> strided stages -> resblocks with the attention stack in
    the middle -> mirrored upsample -> 7x7 tanh head (``include_head``)."""

    def __init__(
        self,
        input_nc: int = 2,
        output_nc: int = 1,
        ngf: int = 64,
        n_downsampling: int = 3,
        n_blocks: int = 9,
        n_attn: int = 0,
        input_size: Tuple[int, int] = (128, 256),
        proj_factor: int = 4,
        heads: int = 4,
        dim_head: int = 128,
        downsample_type: str = "conv",
        upsample_type: str = "interpolate",
        include_head: bool = True,
    ):
        super().__init__()
        self.n_downsampling, self.n_blocks = n_downsampling, n_blocks
        self.include_head = include_head
        self.stem = Conv(input_nc, ngf, 7)
        for i in range(n_downsampling):
            mult = 2 ** i
            self.add_module(f"down{i}", _downsample_layer(
                downsample_type, ngf * mult, ngf * mult * 2))
        mult = 2 ** n_downsampling
        self.attn = None
        if n_attn > 0:
            self.attn = BottleStack(
                ngf * mult, ngf * mult,
                (input_size[0] // mult, input_size[1] // mult),
                n_attn, proj_factor, heads, dim_head)
        for i in range(n_blocks):
            self.add_module(f"res{i}", ResnetBlock(ngf * mult))
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            self.add_module(f"up{i}", _upsample_layer(
                upsample_type, ngf * mult, ngf * mult // 2))
        if include_head:
            self.head = Conv(ngf, output_nc, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = instance_norm_relu(self.stem(reflect_pad(x, 3)))
        for i in range(self.n_downsampling):
            h = instance_norm_relu(getattr(self, f"down{i}")(h))
        mid = self.n_blocks // 2
        for i in range(self.n_blocks):
            if i == mid and self.attn is not None:
                h = self.attn(h)
            h = getattr(self, f"res{i}")(h)
        if self.n_blocks == 0 and self.attn is not None:
            h = self.attn(h)
        for i in range(self.n_downsampling):
            h = instance_norm_relu(getattr(self, f"up{i}")(h))
        if not self.include_head:
            return h
        return torch.tanh(self.head(reflect_pad(h, 3)))


class LocalEnhancer(nn.Module):
    """Two-scale generator: a headless ``GlobalGenerator`` on the avg-pooled
    half-resolution input, added into the full-resolution enhancer branch
    (stem + strided stage, resblocks, upsample, 7x7 tanh head)."""

    def __init__(
        self,
        input_nc: int = 2,
        output_nc: int = 1,
        ngf: int = 32,
        n_downsample_global: int = 3,
        n_blocks_global: int = 9,
        n_local_enhancers: int = 1,
        n_blocks_local: int = 3,
        n_attn_global: int = 0,
        n_attn_local: int = 0,
        input_size: Tuple[int, int] = (128, 256),
        proj_factor_g: int = 4,
        heads_g: int = 4,
        dim_head_g: int = 128,
        downsample_type: str = "conv",
        upsample_type: str = "interpolate",
    ):
        super().__init__()
        if n_local_enhancers != 1:
            raise NotImplementedError("n_local_enhancers != 1 is not ported")
        if n_attn_local > 0:
            raise NotImplementedError("local attention (n_attn_local > 0) is not ported")
        ngf_l = ngf
        self.add_module("global", GlobalGenerator(
            input_nc, output_nc, ngf * 2, n_downsample_global, n_blocks_global,
            n_attn_global, (input_size[0] // 2, input_size[1] // 2),
            proj_factor_g, heads_g, dim_head_g, downsample_type, upsample_type,
            include_head=False))
        self.local_stem = Conv(input_nc, ngf_l, 7)
        self.local_down = _downsample_layer(downsample_type, ngf_l, ngf_l * 2)
        self.n_blocks_local = n_blocks_local
        for i in range(n_blocks_local):
            self.add_module(f"local_res{i}", ResnetBlock(ngf_l * 2))
        self.local_up = _upsample_layer(upsample_type, ngf_l * 2, ngf_l)
        self.local_head = Conv(ngf_l, output_nc, 7)

    @property
    def coarse(self) -> GlobalGenerator:
        return self._modules["global"]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The output before its tanh."""
        coarse = self.coarse(avg_pool_3x3_s2(x))
        h = instance_norm_relu(self.local_stem(reflect_pad(x, 3)))
        h = instance_norm_relu(self.local_down(h)) + coarse
        for i in range(self.n_blocks_local):
            h = getattr(self, f"local_res{i}")(h)
        h = instance_norm_relu(self.local_up(h))
        return self.local_head(reflect_pad(h, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.logits(x))


def build_generator(opt: Mapping) -> nn.Module:
    """Generator from an options dict (keys and defaults of the reference
    ``build_generator``)."""
    get = opt.get
    input_size = (get("bins", 128), get("n_fft", 512) // 2)
    kind = get("netG", "global")
    common = dict(
        input_nc=get("input_nc", 2),
        output_nc=get("output_nc", 1),
        ngf=get("ngf", 64),
        input_size=input_size,
        downsample_type=get("downsample_type", "conv"),
        upsample_type=get("upsample_type", "transconv"),
    )
    if get("fp16", False):
        raise NotImplementedError("the bf16 policy (fp16) is not ported")
    if kind == "global":
        return GlobalGenerator(
            n_downsampling=get("n_downsample_global", 3),
            n_blocks=get("n_blocks_global", 9),
            n_attn=get("n_blocks_attn_g", 0),
            proj_factor=get("proj_factor_g", 4),
            heads=get("heads_g", 4),
            dim_head=get("dim_head_g", 128),
            **common,
        )
    if kind == "local":
        return LocalEnhancer(
            n_downsample_global=get("n_downsample_global", 3),
            n_blocks_global=get("n_blocks_global", 9),
            n_local_enhancers=get("n_local_enhancers", 1),
            n_blocks_local=get("n_blocks_local", 3),
            n_attn_global=get("n_blocks_attn_g", 0),
            n_attn_local=get("n_blocks_attn_l", 0),
            proj_factor_g=get("proj_factor_g", 4),
            heads_g=get("heads_g", 4),
            dim_head_g=get("dim_head_g", 128),
            **common,
        )
    raise ValueError(f"generator [{kind}] not implemented")
