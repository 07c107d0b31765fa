"""pix2pixHD-style generators (NCHW).

The port of ``mdctgan_tpu/models/generator.py``.  Submodule names follow the
Flax tree (``global.down0.conv1.conv``, ``local_res2.conv2.conv``, ...);
``global`` is a Python keyword, so that branch is registered with
``add_module`` and reached through ``self.coarse``.  ``module.train()`` /
``.eval()`` picks the attention stack's BatchNorm statistics (batch or
running), as ``train=`` does in Flax; ``sample_mask`` (B,) 0/1 restricts the
batch statistics to the real rows of a padded tail batch (every other norm
here is per sample).

Ported: ``GlobalGenerator`` (with and without its 7x7 tanh head) and
``LocalEnhancer`` with any number of enhancer branches and local attention,
with the ``conv``/``resconv`` downsample and the ``interpolate``/
``transconv`` upsample.  Each generator keeps its configuration as
attributes, which ``train/import_torch.generator_entries_for`` reads.

``dtype`` (``torch.bfloat16`` under ``fp16``) is the compute dtype of every
convolution (``models/layers.py``); the parameters stay float32.  The
activations between convolutions are bf16 up to the attention stack, whose
float32 output keeps the global resblocks after it on a float32 residual
stream until the first upsample; the 7x7 head's output is cast to float32
before the tanh, so ``forward`` and ``logits`` return float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from mdctgan_tpu_torch.models.attention import BottleStack
from mdctgan_tpu_torch.models.layers import (
    Conv,
    ConvResBlock,
    ConvTransposed,
    InterpolateUpsample,
    ResnetBlock,
    avg_pool_3x3_s2,
    instance_norm_relu,
    lift,
    reflect_pad,
)
from mdctgan_tpu_torch.options import as_dict


def _downsample_layer(kind: str, in_f: int, out_f: int, dtype=None) -> nn.Module:
    if kind == "conv":
        return Conv(in_f, out_f, 3, 2, 1, dtype=dtype)
    if kind == "resconv":
        return ConvResBlock(in_f, out_f, 3, 2, 1, dtype=dtype)
    raise NotImplementedError(f"downsample layer [{kind}] is not found")


def _upsample_layer(kind: str, in_f: int, out_f: int, dtype=None) -> nn.Module:
    if kind == "transconv":
        return ConvTransposed(in_f, out_f, dtype=dtype)
    if kind == "interpolate":
        return InterpolateUpsample(in_f, out_f, dtype=dtype)
    raise NotImplementedError(f"upsample layer [{kind}] is not found")


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
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.n_downsampling, self.n_blocks, self.n_attn = n_downsampling, n_blocks, n_attn
        self.downsample_type, self.upsample_type = downsample_type, upsample_type
        self.include_head, self.compute_dtype = include_head, dtype
        self.stem = Conv(input_nc, ngf, 7, dtype=dtype)
        for i in range(n_downsampling):
            mult = 2 ** i
            self.add_module(f"down{i}", _downsample_layer(
                downsample_type, ngf * mult, ngf * mult * 2, dtype))
        mult = 2 ** n_downsampling
        self.attn = None
        if n_attn > 0:
            self.attn = BottleStack(
                ngf * mult, ngf * mult,
                (input_size[0] // mult, input_size[1] // mult),
                n_attn, proj_factor, heads, dim_head, dtype)
        for i in range(n_blocks):
            self.add_module(f"res{i}", ResnetBlock(ngf * mult, dtype))
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            self.add_module(f"up{i}", _upsample_layer(
                upsample_type, ngf * mult, ngf * mult // 2, dtype))
        if include_head:
            self.head = Conv(ngf, output_nc, 7, dtype=dtype)

    def forward(self, x: torch.Tensor,
                sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.features(x, sample_mask)
        if not self.include_head:
            return h
        return torch.tanh(lift(self.head(reflect_pad(h, 3))))

    def logits(self, x: torch.Tensor,
               sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The output before its tanh (``include_head`` only)."""
        return lift(self.head(reflect_pad(self.features(x, sample_mask), 3)))

    def features(self, x: torch.Tensor,
                 sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The ngf-channel map after the last upsample stage."""
        h = instance_norm_relu(self.stem(reflect_pad(x, 3)))
        for i in range(self.n_downsampling):
            h = instance_norm_relu(getattr(self, f"down{i}")(h))
        mid = self.n_blocks // 2
        for i in range(self.n_blocks):
            if i == mid and self.attn is not None:
                h = self.attn(h, sample_mask)
            h = getattr(self, f"res{i}")(h)
        if self.n_blocks == 0 and self.attn is not None:
            h = self.attn(h, sample_mask)
        for i in range(self.n_downsampling):
            h = instance_norm_relu(getattr(self, f"up{i}")(h))
        return h


class LocalEnhancer(nn.Module):
    """Multi-scale generator: a headless ``GlobalGenerator`` (``global``, at
    ``ngf * 2**n_local_enhancers``) on the coarsest level of an avg-pool
    pyramid, then one enhancer branch per level, coarse to fine, each added
    into the next.  A branch is a stem + strided stage, the coarser
    features added, resblocks with an optional attention bottleneck in the
    middle, and an upsample; the finest branch keeps the bare ``local_*``
    names and alone carries the 7x7 tanh head, the others are named
    ``enh{n}_local_*``.

    The bottleneck (``n_attn_local > 0``) is ``local_attn_down0`` (2 ngf_l
    -> ngf_l), ``local_attn_down_shared`` called twice, the ``BottleStack``
    ``local_attn`` at the branch's size // 16 (placed even without
    resblocks), and after the resblocks ``local_attn_up_shared`` called
    three times: the reference builds those stages by list multiplication,
    which repeats one module, so each shared module has one set of
    weights."""

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
        proj_factor_l: int = 4,
        heads_l: int = 4,
        dim_head_l: int = 128,
        downsample_type: str = "conv",
        upsample_type: str = "interpolate",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.n_downsample_global, self.n_blocks_global = n_downsample_global, n_blocks_global
        self.n_attn_global, self.n_attn_local = n_attn_global, n_attn_local
        self.n_local_enhancers, self.n_blocks_local = n_local_enhancers, n_blocks_local
        self.downsample_type, self.upsample_type = downsample_type, upsample_type
        self.compute_dtype = dtype
        n_enh = n_local_enhancers
        self.add_module("global", GlobalGenerator(
            input_nc, output_nc, ngf * 2 ** n_enh, n_downsample_global, n_blocks_global,
            n_attn_global, (input_size[0] // 2 ** n_enh, input_size[1] // 2 ** n_enh),
            proj_factor_g, heads_g, dim_head_g, downsample_type, upsample_type,
            include_head=False, dtype=dtype))
        # the branches' name prefixes, coarse to fine
        self.prefixes = [f"enh{n}_" for n in range(1, n_enh)] + [""]
        for n, prefix in enumerate(self.prefixes, start=1):
            ngf_l, level = ngf * 2 ** (n_enh - n), 2 ** (n_enh - n)

            def add(name: str, module: nn.Module, prefix=prefix) -> None:
                self.add_module(prefix + name, module)

            add("local_stem", Conv(input_nc, ngf_l, 7, dtype=dtype))
            add("local_down", _downsample_layer(downsample_type, ngf_l, ngf_l * 2, dtype))
            if n_attn_local > 0:
                add("local_attn_down0", _downsample_layer(
                    downsample_type, ngf_l * 2, ngf_l, dtype))
                add("local_attn_down_shared", _downsample_layer(
                    downsample_type, ngf_l, ngf_l, dtype))
                add("local_attn", BottleStack(
                    ngf_l, ngf_l * 2,
                    (input_size[0] // level // 16, input_size[1] // level // 16),
                    n_attn_local, proj_factor_l, heads_l, dim_head_l, dtype))
            for i in range(n_blocks_local):
                add(f"local_res{i}", ResnetBlock(ngf_l * 2, dtype))
            if n_attn_local > 0:
                add("local_attn_up_shared", _upsample_layer(
                    upsample_type, ngf_l * 2, ngf_l * 2, dtype))
            add("local_up", _upsample_layer(upsample_type, ngf_l * 2, ngf_l, dtype))
        self.local_head = Conv(ngf, output_nc, 7, dtype=dtype)

    @property
    def coarse(self) -> GlobalGenerator:
        return self._modules["global"]

    def _attn_bottleneck(self, prefix: str, h: torch.Tensor,
                         sample_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """8x down (the shared stage twice), then the attention stack."""
        h = instance_norm_relu(self._modules[prefix + "local_attn_down0"](h))
        shared = self._modules[prefix + "local_attn_down_shared"]
        for _ in range(2):
            h = instance_norm_relu(shared(h))
        return self._modules[prefix + "local_attn"](h, sample_mask)

    def _branch(self, prefix: str, coarse: torch.Tensor, x: torch.Tensor,
                sample_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """One enhancer branch up to its upsample (the head is the caller's)."""
        m = self._modules
        h = instance_norm_relu(m[prefix + "local_stem"](reflect_pad(x, 3)))
        h = instance_norm_relu(m[prefix + "local_down"](h)) + coarse
        mid = self.n_blocks_local // 2
        for i in range(self.n_blocks_local):
            if i == mid and self.n_attn_local > 0:
                h = self._attn_bottleneck(prefix, h, sample_mask)
            h = m[f"{prefix}local_res{i}"](h)
        if self.n_blocks_local == 0 and self.n_attn_local > 0:
            h = self._attn_bottleneck(prefix, h, sample_mask)
        if self.n_attn_local > 0:
            shared = m[prefix + "local_attn_up_shared"]
            for _ in range(3):
                h = instance_norm_relu(shared(h))
        return instance_norm_relu(m[prefix + "local_up"](h))

    def logits(self, x: torch.Tensor,
               sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The output before its tanh."""
        levels = [x]
        for _ in self.prefixes:
            levels.append(avg_pool_3x3_s2(levels[-1]))
        h = self.coarse(levels[-1], sample_mask)
        for prefix, level in zip(self.prefixes, reversed(levels[:-1])):
            h = self._branch(prefix, h, level, sample_mask)
        return lift(self.local_head(reflect_pad(h, 3)))

    def forward(self, x: torch.Tensor,
                sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return torch.tanh(self.logits(x, sample_mask))


def build_generator(opt) -> nn.Module:
    """Generator from an options dict or a parsed namespace (keys and
    defaults of the reference ``build_generator``); ``fp16`` computes in
    bf16."""
    get = as_dict(opt).get
    input_size = (get("bins", 128), get("n_fft", 512) // 2)
    kind = get("netG", "global")
    common = dict(
        input_nc=get("input_nc", 2),
        output_nc=get("output_nc", 1),
        ngf=get("ngf", 64),
        input_size=input_size,
        downsample_type=get("downsample_type", "conv"),
        upsample_type=get("upsample_type", "transconv"),
        dtype=torch.bfloat16 if get("fp16", False) else None,
    )
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
            proj_factor_l=get("proj_factor_l", 4),
            heads_l=get("heads_l", 4),
            dim_head_l=get("dim_head_l", 128),
            **common,
        )
    raise ValueError(f"generator [{kind}] not implemented")
