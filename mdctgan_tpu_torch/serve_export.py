"""Serve a program that ``export_cli`` wrote: the port's counterpart of
``jax.export.deserialize(...).call``.

    from mdctgan_tpu_torch.serve_export import load
    serve = load("model.pt2")                # the program's first platform
    serve = load("model.pt2", device="cpu")  # a platform the program names
    sr_segments = serve(lr_segments)  # (export_batch, segment_length) float32

Importing ``mdctgan_tpu_torch.ops.mdct_kernels`` (which registers the
operators ``mdctgan::mdct_spectro`` and ``mdctgan::imdct_audio`` that the
program calls) is the only model code needed: the generator's structure
and weights are in the program.  This module imports nothing else of the
package but ``device``.

The program records the platforms it was exported for (``--export_platforms``,
the file's ``RECORD``): ``tpu`` and ``cuda`` name the card, ``cpu`` the CPU.
``load`` places its state and every node that names a device on one of
them: by default the first (the card is ``cuda:0``, raising without CUDA),
or the ``device`` asked for, which must be one the program names.  There is
no fallback: a program for the card never runs on the CPU unasked.  A
program written without a record runs on the device of its weights.  The
input must lie on the device the program was placed on; on the card it
launches K1 and K2 there, counted in ``mdct_kernels.LAUNCHES``.
"""

from __future__ import annotations

import json
import zipfile
from typing import Callable, List, Optional, Union

import torch
from torch.export.passes import move_to_device_pass

import mdctgan_tpu_torch.ops.mdct_kernels  # noqa: F401  (registers the operators)
from mdctgan_tpu_torch.device import float32_policy, resolve_device

# the device type that each name of --export_platforms asks for
PLATFORMS = {"tpu": "cuda", "cuda": "cuda", "cpu": "cpu"}
# the program's extra file that lists its platforms (a JSON list of names)
RECORD = "mdctgan_platforms.json"


def platforms_of(path: str) -> Optional[List[str]]:
    """The platforms the program at ``path`` records, read from its archive
    without loading its state; None for a program without a record."""
    with zipfile.ZipFile(path) as archive:
        names = [n for n in archive.namelist() if n.endswith(f"/extra/{RECORD}")]
        return json.loads(archive.read(names[0])) if names else None


def _target(platforms: List[str], device: Union[str, torch.device, None]) -> torch.device:
    """The device that ``device`` asks for among ``platforms``: None the
    first platform's (the card is ``cuda:0``)."""
    kinds = [PLATFORMS[p] for p in platforms]
    if device is None:
        return resolve_device("cuda:0" if kinds[0] == "cuda" else "cpu")
    dev = resolve_device(device)
    if dev.type not in kinds:
        raise ValueError(f"device {str(dev)!r}: the program is for {','.join(platforms)}")
    return dev


def load(path: str, device: Union[str, torch.device, None] = None
         ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The program at ``path`` on ``device`` (the module docstring) as a
    function of the LR segments, run under ``torch.inference_mode()`` and
    the float32 policy (TF32 off): the program carries no precision switch
    of its own, and its convolutions obey the process's."""
    platforms = platforms_of(path)
    target = None if platforms is None else _target(platforms, device)
    program = torch.export.load(path)
    held = {t.device for t in (*program.state_dict.values(), *program.constants.values())
            if isinstance(t, torch.Tensor)}
    if target is None:  # written without a record: the platform of its weights
        here = next(iter(held))
        target = here if device is None else _target([here.type], device)
    if held != {target}:
        program = move_to_device_pass(program, target)
    module = program.module()

    def serve(lr_segments: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), float32_policy():
            return module(lr_segments)

    return serve
