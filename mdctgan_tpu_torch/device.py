"""Device resolution and the float32 precision policy."""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent.  There is no silent move to the CPU: only an explicit ``"cpu"``
    runs there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


@contextlib.contextmanager
def float32_policy(allow_tf32: bool = False) -> Iterator[None]:
    """Within the block, run float32 products in full float32 on the card
    (or in TF32 with ``allow_tf32=True``); the caller's settings come back
    on exit, so the port changes nothing for other code in the process.

    PyTorch keeps float32 matmuls in full precision by default but lets
    cuDNN run float32 convolutions in TF32, which keeps about three decimal
    digits.  The port is held against the float32 reference at absolute
    bounds of 5e-4 (generator) and 2e-3 relative (waveform, after a sinh
    denormalization whose slope reaches ~575x), so its entry points run
    under this policy with TF32 off.  A faster precision (bf16 autocast) is
    a later, measured change, not a default."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
