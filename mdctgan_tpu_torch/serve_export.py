"""Serve a program that ``export_cli`` wrote: the port's counterpart of
``jax.export.deserialize(...).call``.

    from mdctgan_tpu_torch.serve_export import load
    serve = load("model.pt2")
    sr_segments = serve(lr_segments)  # (export_batch, segment_length) float32

Importing ``mdctgan_tpu_torch.ops.mdct_kernels`` (which registers the
operators ``mdctgan::mdct_spectro`` and ``mdctgan::imdct_audio`` that the
program calls) is the only model code needed: the generator's structure
and weights are in the program.  This module imports nothing else of the
package but ``device.float32_policy``.  The input must lie on the device
the program was exported for; a program for the card launches K1 and K2
there, counted in ``mdct_kernels.LAUNCHES``.
"""

from __future__ import annotations

from typing import Callable

import torch

import mdctgan_tpu_torch.ops.mdct_kernels  # noqa: F401  (registers the operators)
from mdctgan_tpu_torch.device import float32_policy


def load(path: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The program at ``path`` as a function of the LR segments, run under
    ``torch.inference_mode()`` and the float32 policy (TF32 off): the
    program carries no precision switch of its own, and its convolutions
    obey the process's."""
    program = torch.export.load(path).module()

    def serve(lr_segments: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), float32_policy():
            return program(lr_segments)

    return serve
