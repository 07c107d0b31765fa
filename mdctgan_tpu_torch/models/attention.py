"""Bottleneck-transformer attention stack (NCHW shapes).

The port of ``mdctgan_tpu/models/attention.py`` (itself a re-implementation
of ``bottleneck_transformer_pytorch==0.1.4`` with ``downsample=False`` and
``rel_pos_emb=False``).  BatchNorm follows ``module.train()``/``.eval()``:
batch statistics, optionally restricted to the real rows of a padded batch
by ``mask``, in train mode; running statistics in eval mode.  Under data
parallelism (``sync_batch_stats``) the batch statistics are the global
batch's, pooled across the ranks, as the JAX package's mesh step computes
them over the whole batch.

Layout, as in the reference: the qkv channel axis splits as
``(3, heads, dim_head)`` with the 3 outermost, tokens are the row-major
flattening of (H, W), and the attention output returns to channels as
``(heads, dim_head)`` with heads outermost.  On channels-last activations
(``layers.conv_nhwc``) the same splits are views over the (B, H, W, C)
bytes, and the output returns channels-last.

Under a compute ``dtype`` (the bf16 policy) only the 1x1 convolutions run
in it, as in the JAX package: the qkv projection is cast back to float32
before the attention math, and every BatchNorm normalizes its input in
float32, so the block's output is float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from mdctgan_tpu_torch.models.layers import channels_last, conv_forward, lift, reduce_mean
from mdctgan_tpu_torch.parallel.mesh import gather_over_ranks


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
                 dim_head: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads, self.dim_head, self.compute_dtype = heads, dim_head, dtype
        self.to_qkv = nn.Conv2d(dim, 3 * heads * dim_head, 1, bias=False)
        self.pos_emb = AbsPosEmb2D(fmap_size, dim_head)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        heads, dh = self.heads, self.dim_head
        qkv = lift(conv_forward(self.to_qkv, x, self.compute_dtype))
        nhwc = channels_last(qkv)
        if nhwc:  # (b, n, 3, heads, d) over the channels-last bytes
            qkv = qkv.permute(0, 2, 3, 1).reshape(b, h * w, 3, heads, dh)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # b,heads,n,d
        else:
            qkv = qkv.reshape(b, 3, heads, dh, h * w)
            q, k, v = (qkv[:, i].transpose(-1, -2) for i in range(3))  # b,heads,n,d
        q = q * (dh ** -0.5)
        sim = torch.matmul(q, k.transpose(-1, -2)) + self.pos_emb(q)
        attn = torch.softmax(sim, dim=-1)
        out = torch.matmul(attn, v)  # b, heads, n, d
        if nhwc:
            return out.transpose(1, 2).reshape(b, h, w, heads * dh).permute(0, 3, 1, 2)
        return out.transpose(-1, -2).reshape(b, heads * dh, h, w)


def _pool_over_ranks(n: torch.Tensor, s: torch.Tensor, dev: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The global batch's count, mean and squared deviations about that mean,
    from each rank's count ``n``, sums ``s`` and squared deviations ``dev``
    about its own mean, through one all-reduce (``gather_over_ranks``):
    Chan, Golub and LeVeque's pairwise update, which only adds non-negative
    terms and so keeps the two-pass form's accuracy.  At one rank it returns
    the rank's own numbers, bit for bit."""
    c = s.shape[0]
    stats = gather_over_ranks(torch.cat((n.reshape(1), s, dev)))
    ns, ss, devs = stats[:, :1], stats[:, 1:c + 1], stats[:, c + 1:]
    n = ns.sum()
    mean = ss.sum(dim=0) / torch.clamp(n, min=1.0)
    means = ss / torch.clamp(ns, min=1.0)
    return n, mean, (devs + ns * (means - mean).square()).sum(dim=0)


class _BN2d(nn.Module):
    """BatchNorm2d (momentum 0.1, eps 1e-5) with exactly the tensors of the
    Flax ``BatchNorm`` tree: scale/bias as ``weight``/``bias`` and mean/var
    as the ``running_mean``/``running_var`` buffers.

    In train mode it normalizes every row with the biased two-pass batch
    variance E[(x - mean)^2] (never E[x^2] - mean^2, which cancels in f32).
    A 0/1 ``mask`` of shape (B,) restricts the statistics to the rows where
    it is 1, so a padded tail batch normalizes as the smaller batch would.
    The running variance tracks the Bessel-corrected n/(n-1) estimate, with
    n = sum(mask)*H*W, as ``torch.nn.BatchNorm2d`` does.  Stock
    ``BatchNorm2d`` cannot mask, hence this module.  A bf16 input is
    normalized in float32 and the output is float32.

    With ``across_ranks`` (``sync_batch_stats``) the statistics are those
    of the global batch: each rank's masked count, sums and squared
    deviations about its own mean are pooled through one all-reduce each
    way (``_pool_over_ranks``), with their gradient; every rank gets the
    same statistics and running statistics, and at one rank the single
    card's.  ``SyncBatchNorm`` cannot mask either."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.across_ranks = False
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = lift(x)
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            hw = x.shape[2] * x.shape[3]
            if mask is None and not self.across_ranks:
                n = float(x.shape[0] * hw)
                bessel = n / max(n - 1.0, 1.0)
                mean = reduce_mean(x, (0, 2, 3))
                var = reduce_mean((x - mean[:, None, None]).square(), (0, 2, 3))
            else:
                # the masked sums and count, then the squared deviations
                # about their mean (a rank may keep no row: hence the clamp)
                m = (torch.ones(x.shape[0], device=x.device, dtype=x.dtype) if mask is None
                     else mask.to(x.dtype)).reshape(-1, 1, 1, 1)
                n = m.sum() * hw
                s = (x * m).sum(dim=(0, 2, 3))
                mean = s / torch.clamp(n, min=1.0)
                dev = ((x - mean[:, None, None]).square() * m).sum(dim=(0, 2, 3))
                if self.across_ranks:
                    n, mean, dev = _pool_over_ranks(n, s, dev)
                bessel = n / torch.clamp(n - 1.0, min=1.0)
                var = dev / n
            with torch.no_grad():
                mom = self.momentum
                self.running_mean.copy_((1.0 - mom) * self.running_mean + mom * mean)
                self.running_var.copy_((1.0 - mom) * self.running_var + mom * (bessel * var))
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def sync_batch_stats(module: nn.Module) -> nn.Module:
    """Make every masked BatchNorm under ``module`` take the global batch's
    statistics across the ranks of the default process group; returns
    ``module``."""
    for m in module.modules():
        if isinstance(m, _BN2d):
            m.across_ranks = True
    return module


class BatchNorm(nn.Module):
    """The Flax ``BatchNorm`` wrapper scope: one child ``bn``."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn = _BN2d(channels)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.bn(x, mask)


class BottleBlock(nn.Module):
    """relu(BN(proj_out(relu(BN(attn(relu(BN(proj_in(x)))))))) + shortcut(x))
    with a 1x1 conv + BN + relu shortcut when the width changes."""

    def __init__(self, dim: int, dim_out: int, fmap_size: Tuple[int, int],
                 proj_factor: int = 4, heads: int = 4, dim_head: int = 128,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.has_shortcut = dim != dim_out
        if self.has_shortcut:
            self.shortcut_conv = nn.Conv2d(dim, dim_out, 1, bias=False)
            self.shortcut_bn = BatchNorm(dim_out)
        attn_dim_in = dim_out // proj_factor
        inner = heads * dim_head
        self.proj_in = nn.Conv2d(dim, attn_dim_in, 1, bias=False)
        self.bn1 = BatchNorm(attn_dim_in)
        self.attn = Attention2D(attn_dim_in, fmap_size, heads, dim_head, dtype)
        self.bn2 = BatchNorm(inner)
        self.proj_out = nn.Conv2d(inner, dim_out, 1, bias=False)
        self.bn3 = BatchNorm(dim_out)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.compute_dtype
        shortcut = x
        if self.has_shortcut:
            shortcut = torch.relu(self.shortcut_bn(
                conv_forward(self.shortcut_conv, x, dtype), mask))
        h = torch.relu(self.bn1(conv_forward(self.proj_in, x, dtype), mask))
        h = torch.relu(self.bn2(self.attn(h), mask))
        h = self.bn3(conv_forward(self.proj_out, h, dtype), mask)
        return torch.relu(h + shortcut)


class BottleStack(nn.Module):
    """Blocks ``block0 .. block{n-1}``; the first maps dim -> dim_out."""

    def __init__(self, dim: int, dim_out: int, fmap_size: Tuple[int, int],
                 num_layers: int = 3, proj_factor: int = 4, heads: int = 4,
                 dim_head: int = 128, dtype: Optional[torch.dtype] = None):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"block{i}", BottleBlock(
                dim if i == 0 else dim_out, dim_out, fmap_size, proj_factor,
                heads, dim_head, dtype))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask`` (B,) 0/1 restricts every BatchNorm's train-mode
        statistics to the real rows; eval mode ignores it."""
        for block in self.children():
            x = block(x, mask)
        return x
