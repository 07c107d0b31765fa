"""Bottleneck-transformer attention stack (NCHW), inference form.

The port of ``mdctgan_tpu/models/attention.py`` (itself a re-implementation
of ``bottleneck_transformer_pytorch==0.1.4`` with ``downsample=False`` and
``rel_pos_emb=False``).  BatchNorm runs on its running statistics; the
train-mode masked statistics belong to the training port.

Layout, as in the reference: the qkv channel axis splits as
``(3, heads, dim_head)`` with the 3 outermost, tokens are the row-major
flattening of (H, W), and the attention output returns to channels as
``(heads, dim_head)`` with heads outermost.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn


class AbsPosEmb2D(nn.Module):
    """Factored absolute positional embedding: logits[i, j] = q_i . (h + w)_j."""

    def __init__(self, fmap_size: Tuple[int, int], dim_head: int):
        super().__init__()
        h, w = fmap_size
        self.height = nn.Parameter(torch.empty(h, dim_head))
        self.width = nn.Parameter(torch.empty(w, dim_head))

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        emb = (self.height[:, None, :] + self.width[None, :, :]).reshape(
            -1, self.height.shape[-1])
        return torch.matmul(q, emb.t())


class Attention2D(nn.Module):
    """Multi-head self-attention over a (B, C, H, W) feature map."""

    def __init__(self, dim: int, fmap_size: Tuple[int, int], heads: int,
                 dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = nn.Conv2d(dim, 3 * heads * dim_head, 1, bias=False)
        self.pos_emb = AbsPosEmb2D(fmap_size, dim_head)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        heads, dh = self.heads, self.dim_head
        qkv = self.to_qkv(x).reshape(b, 3, heads, dh, h * w)
        q, k, v = (qkv[:, i].transpose(-1, -2) for i in range(3))  # b,heads,n,d
        q = q * (dh ** -0.5)
        sim = torch.matmul(q, k.transpose(-1, -2)) + self.pos_emb(q)
        attn = torch.softmax(sim, dim=-1)
        out = torch.matmul(attn, v)  # b, heads, n, d
        return out.transpose(-1, -2).reshape(b, heads * dh, h, w)


class _BN2d(nn.Module):
    """BatchNorm2d on running statistics (eps 1e-5), with exactly the
    tensors of the Flax ``BatchNorm`` tree: scale/bias as ``weight``/``bias``
    and mean/var as the ``running_mean``/``running_var`` buffers."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class BatchNorm(nn.Module):
    """The Flax ``BatchNorm`` wrapper scope: one child ``bn``."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn = _BN2d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class BottleBlock(nn.Module):
    """relu(BN(proj_out(relu(BN(attn(relu(BN(proj_in(x)))))))) + shortcut(x))
    with a 1x1 conv + BN + relu shortcut when the width changes."""

    def __init__(self, dim: int, dim_out: int, fmap_size: Tuple[int, int],
                 proj_factor: int = 4, heads: int = 4, dim_head: int = 128):
        super().__init__()
        self.has_shortcut = dim != dim_out
        if self.has_shortcut:
            self.shortcut_conv = nn.Conv2d(dim, dim_out, 1, bias=False)
            self.shortcut_bn = BatchNorm(dim_out)
        attn_dim_in = dim_out // proj_factor
        inner = heads * dim_head
        self.proj_in = nn.Conv2d(dim, attn_dim_in, 1, bias=False)
        self.bn1 = BatchNorm(attn_dim_in)
        self.attn = Attention2D(attn_dim_in, fmap_size, heads, dim_head)
        self.bn2 = BatchNorm(inner)
        self.proj_out = nn.Conv2d(inner, dim_out, 1, bias=False)
        self.bn3 = BatchNorm(dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.has_shortcut:
            shortcut = torch.relu(self.shortcut_bn(self.shortcut_conv(x)))
        h = torch.relu(self.bn1(self.proj_in(x)))
        h = torch.relu(self.bn2(self.attn(h)))
        h = self.bn3(self.proj_out(h))
        return torch.relu(h + shortcut)


class BottleStack(nn.Module):
    """Blocks ``block0 .. block{n-1}``; the first maps dim -> dim_out."""

    def __init__(self, dim: int, dim_out: int, fmap_size: Tuple[int, int],
                 num_layers: int = 3, proj_factor: int = 4, heads: int = 4,
                 dim_head: int = 128):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"block{i}", BottleBlock(
                dim if i == 0 else dim_out, dim_out, fmap_size, proj_factor,
                heads, dim_head))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x
