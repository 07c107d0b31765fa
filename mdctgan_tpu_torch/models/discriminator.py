"""PatchGAN discriminators (NCHW shapes).

The port of ``mdctgan_tpu/models/discriminator.py``.  Each scale returns the
list of its intermediate features (the reference's ``getIntermFeat``) for
the feature-matching loss; the last element is the patch logit map.  Module
names follow the Flax tree (``scale2.layer0.conv``), so
``weights.state_dict_from_jax`` carries a Flax discriminator as it carries
a generator.  The JAX package's column-phased ``layer0`` is a TPU form of
the same convolution; here it is a plain one.  Under ``fp16`` every
convolution computes in bf16 (``models/layers.py``), the intermediate
features stay bf16 and the logit map is cast to float32; on the card each
scale's input enters channels-last (``layers.conv_layout``) and the
features stay so.  The pyramid's pools run on the NCHW input: the card's
channels-last average pool returns a wrong gradient (torch 2.11 cu128),
which doubled the bf16 train step's G gradient error against float64
(``chip_smoke.py`` phase 8b).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from mdctgan_tpu_torch.models.layers import (
    Conv, avg_pool_3x3_s2, conv_layout, instance_norm, leaky_relu, lift)
from mdctgan_tpu_torch.options import as_dict, train_options


class NLayerDiscriminator(nn.Module):
    """4x4 convs with padding 2: ``n_layers`` stride-2 stages (the first
    without a norm, channels doubling up to 512), one stride-1 stage, then a
    1-channel logit conv; instance norm and leaky ReLU (0.2) between."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 use_sigmoid: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_layers, self.use_sigmoid = n_layers, use_sigmoid
        self.layer0 = Conv(input_nc, ndf, 4, 2, 2, dtype=dtype)
        nf = ndf
        for n in range(1, n_layers):
            prev, nf = nf, min(nf * 2, 512)
            self.add_module(f"layer{n}", Conv(prev, nf, 4, 2, 2, dtype=dtype))
        prev, nf = nf, min(nf * 2, 512)
        self.add_module(f"layer{n_layers}", Conv(prev, nf, 4, 1, 2, dtype=dtype))
        self.add_module(f"layer{n_layers + 1}", Conv(nf, 1, 4, 1, 2, dtype=dtype))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = leaky_relu(self.layer0(x))
        feats = [h]
        for n in range(1, self.n_layers + 1):
            h = leaky_relu(instance_norm(getattr(self, f"layer{n}")(h)))
            feats.append(h)
        h = lift(getattr(self, f"layer{self.n_layers + 1}")(h))
        feats.append(torch.sigmoid(h) if self.use_sigmoid else h)
        return feats


class MultiscaleDiscriminator(nn.Module):
    """``num_D`` PatchGANs over a stride-2 average-pool pyramid.  Returns one
    feature list per scale, the full-resolution input first; the
    discriminator that sees the input pooled i times is named
    ``scale{num_D-1-i}``, as in the reference."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 num_D: int = 3, use_sigmoid: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_D, self.compute_dtype = num_D, dtype
        for i in range(num_D):
            self.add_module(f"scale{num_D - 1 - i}",
                            NLayerDiscriminator(input_nc, ndf, n_layers, use_sigmoid, dtype))

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        results = []
        for i in range(self.num_D):
            results.append(getattr(self, f"scale{self.num_D - 1 - i}")(
                conv_layout(x, self.compute_dtype)))
            if i != self.num_D - 1:
                x = avg_pool_3x3_s2(x)
        return results


def build_discriminator(opt) -> MultiscaleDiscriminator:
    """Discriminator from an options dict or a parsed namespace, with the
    defaults of ``options.train_options`` (which raises for what the port
    does not train yet); ``fp16`` computes in bf16.  It sees the LR
    spectrum beside the generator's input channels of an image:
    ``input_nc + output_nc``."""
    tro = train_options(opt)
    o = as_dict(opt)
    return MultiscaleDiscriminator(
        input_nc=o.get("input_nc", 2) + o.get("output_nc", 1),
        ndf=tro["ndf"],
        n_layers=tro["n_layers_D"],
        num_D=tro["num_D"],
        use_sigmoid=bool(tro["no_lsgan"]),
        dtype=torch.bfloat16 if tro["fp16"] else None,
    )
