"""Seeded weights on the device, in float32 (the type the port keeps its
parameters in under bf16): one ``torch.randn`` a network from a generator
on the device, sliced into the state dict of the reference's layout, which
is the port's.

    convolution weights and biases   N(0, 0.02)
    BatchNorm weight / bias          1 + N(0, 0.02) / N(0, 0.02)
    BatchNorm running mean / var     N(0, 0.1) / exp(N(0, 0.2))
    position embeddings              N(0, dim_head ** -0.5)
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from perfbench.reference.models import Discriminator, build_generator

StateDict = Dict[str, torch.Tensor]


def _fill(module: torch.nn.Module, gen: torch.Generator, device) -> StateDict:
    layout = [(k, tuple(v.shape)) for k, v in module.state_dict().items()]
    total = sum(torch.Size(s).numel() for _, s in layout)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for key, shape in layout:
        n = torch.Size(shape).numel()
        z = flat[at:at + n].view(shape)
        at += n
        leaf = key.rsplit(".", 1)[-1]
        if key.endswith("bn.weight"):
            v = 1.0 + 0.02 * z
        elif leaf == "running_mean":
            v = 0.1 * z
        elif leaf == "running_var":
            v = torch.exp(0.2 * z)
        elif leaf in ("height", "width"):
            v = z * shape[-1] ** -0.5
        else:
            v = 0.02 * z
        out[key] = v.contiguous()
    return out


def seeded_state_dicts(opt, device, seed: int, discriminator: bool = True
                       ) -> Tuple[StateDict, StateDict]:
    """(G's, D's or None) state dicts drawn from ``seed`` on ``device``."""
    with torch.device("meta"):
        g = build_generator(opt)
        d = Discriminator(opt) if discriminator else None
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return _fill(g, gen, device), (_fill(d, gen, device) if d is not None else None)
