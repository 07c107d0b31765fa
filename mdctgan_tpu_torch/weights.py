"""Weights: the carry from the Flax trees, and seeded initialisation.

The port's parameter names are the Flax tree paths joined with dots, so the
carry from ``{"params", "batch_stats"}`` is a rename plus a transpose:

    conv ``kernel`` (kH, kW, I, O)    -> ``weight`` (O, I, kH, kW)
    BatchNorm ``scale`` / ``bias``     -> ``weight`` / ``bias``
    batch_stats ``mean`` / ``var``     -> ``running_mean`` / ``running_var``
    ``pos_emb`` ``height`` / ``width`` -> unchanged
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from mdctgan_tpu_torch.models.attention import AbsPosEmb2D, _BN2d

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "height": "height", "width": "width"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def state_dict_from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``params`` and ``batch_stats`` trees (nested dicts of arrays) ->
    a ``state_dict`` that the port's generator loads with ``strict=True``."""
    out: Dict[str, torch.Tensor] = {}
    for tree, leaves in ((params, _PARAM_LEAF), (batch_stats or {}, _STAT_LEAF)):
        for path, value in _flatten(tree):
            if path[-1] not in leaves:
                raise KeyError(f"unexpected leaf {'/'.join(path)}")
            v = np.asarray(value, np.float32)
            if path[-1] == "kernel":
                v = np.transpose(v, (3, 2, 0, 1))
            key = ".".join(path[:-1] + (leaves[path[-1]],))
            out[key] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def random_jax_trees(module: nn.Module, rng: np.random.Generator):
    """Seeded random ``(params, batch_stats)`` in the Flax layout for
    ``module``: every parameter N(0, 0.05), running means N(0, 0.1), running
    variances U(0.5, 1.5)."""
    params: Dict = {}
    stats: Dict = {}
    inverse = {"running_mean": "mean", "running_var": "var"}
    for key, t in module.state_dict().items():
        *path, leaf = key.split(".")
        if leaf in inverse:
            tree, leaf = stats, inverse[leaf]
            v = (rng.normal(0.0, 0.1, t.shape) if leaf == "mean"
                 else rng.uniform(0.5, 1.5, t.shape))
        else:
            tree = params
            shape = tuple(t.shape)
            if leaf == "weight" and t.dim() == 4:
                leaf = "kernel"
                shape = (shape[2], shape[3], shape[1], shape[0])
            elif leaf == "weight":
                leaf = "scale"
            v = rng.normal(0.0, 0.05, shape)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.astype(np.float32)
    return params, stats


@torch.no_grad()
def init_weights(module: nn.Module, gen: torch.Generator) -> None:
    """The reference initialisation, drawn from ``gen``: conv weights
    N(0, 0.02) and zero biases, BatchNorm weights N(1, 0.02) and zero biases
    with running statistics (0, 1), positional embeddings
    N(0, dim_head**-0.5)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.02)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, _BN2d):
            m.weight.copy_(1.0 + torch.randn(m.weight.shape, generator=gen) * 0.02)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, AbsPosEmb2D):
            scale = m.height.shape[-1] ** -0.5
            m.height.copy_(torch.randn(m.height.shape, generator=gen) * scale)
            m.width.copy_(torch.randn(m.width.shape, generator=gen) * scale)
