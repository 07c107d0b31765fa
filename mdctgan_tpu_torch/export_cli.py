"""The serving export: the port of ``mdctgan_tpu/export_cli.py``.

The serving chain (K1 -> LocalEnhancer -> fit_residual -> K2, the
generator's weights inside) goes through ``torch.export`` into one program
file, as the JAX package serializes its jitted chain to StableHLO:

    python -m mdctgan_tpu_torch.export_cli --load_pretrain DIR \\
        --export_path model.pt2 --export_batch 8 ...model flags...

``DIR`` holds ``<which_epoch>_net_G.pth`` in the reference's key layout or
the ``ckpt/`` of a run of the port's train CLI, as for ``generate_cli``.
The program takes (``--export_batch``, ``segment_length``) float32 LR
segments and returns the SR segments of the same shape; another batch
raises.  ``--fp16`` exports the bf16 generator; K1 and K2 stay float32.

K1 and K2 are the registered operators of ``ops/mdct_kernels.py``, nodes of
the exported graph where the configuration runs them (``fused_compatible``;
the matmul form elsewhere), so the program launches the hand-written
kernels on the card and runs their plain versions on the CPU.

Device: ``cuda:<gpu_ids>`` (the first id; default 0, raising without CUDA),
or the CPU with ``--gpu_ids -1``.  ``--export_platforms`` lists the
platforms the program is for: ``tpu`` (the flag's default, kept so that
``opt.txt`` reads as the JAX package's) and ``cuda`` name the card, ``cpu``
the CPU.  The export device's platform must be in the list; an empty or
unknown name, or a list without it, raises ``ValueError``.  The file
records the list (``serve_export.RECORD``), so one program serves on any
platform it names: ``serve_export.load(path, device=)`` places its state
and every node that names a device there.  A program exported on the card
for a list that names the CPU is moved to the CPU before the save
(``torch.export.passes.move_to_device_pass``), so that a host without a
card can read it; one copy of the weights is held either way.

The JAX package turns ``--fused_mdct auto`` off for any artifact but a
``tpu`` one, because its Pallas kernels lower for the TPU alone.  Here K1
and K2 stay operator nodes on every platform (``fused_compatible`` decides,
as for one platform): their CPU kernel is the plain version, their CUDA
kernel the hand-written one, chosen where the program runs.

Reload with ``serve_export.load`` (or ``torch.export.load`` after
``import mdctgan_tpu_torch.ops.mdct_kernels``): no other model code is
needed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
from torch.export.passes import move_to_device_pass

from mdctgan_tpu_torch.device import float32_policy
from mdctgan_tpu_torch.models.generator import build_generator
from mdctgan_tpu_torch.ops.features import SpectralTransform
from mdctgan_tpu_torch.options import TrainOptions, serving_devices, spectral_config_from_opt
from mdctgan_tpu_torch.serve_export import PLATFORMS, RECORD
from mdctgan_tpu_torch.train.restore import load_generator_state
from mdctgan_tpu_torch.train.step import InferenceModule


class ServingProgram(nn.Module):
    """What is exported: ``InferenceModule``'s SR waveform, with its state
    (the generator's weights, the transform's matrices) held here under
    flat names (``.`` as ``__``) and handed to it by ``functional_call``.
    The program's module is generated as Python code that reaches each
    state by its dotted name, and the LocalEnhancer's coarse branch is named
    ``global`` as in the Flax tree: a keyword, which that code cannot
    spell."""

    def __init__(self, body: InferenceModule):
        super().__init__()
        self._body = (body,)  # not a submodule: its state is held below
        self._flat = {}
        for name, p in body.named_parameters():
            self._flat[name] = name.replace(".", "__")
            self.register_parameter(self._flat[name], p)
        for name, b in body.named_buffers():
            self._flat[name] = name.replace(".", "__")
            self.register_buffer(self._flat[name], b)

    def forward(self, lr_segments: torch.Tensor) -> torch.Tensor:
        state = {name: getattr(self, flat) for name, flat in self._flat.items()}
        return torch.func.functional_call(self._body[0], state, (lr_segments,))[1]


def parse_platforms(opt) -> List[str]:
    """``--export_platforms`` as a list of names, each one of
    ``PLATFORMS``."""
    platforms = [p.strip() for p in opt.export_platforms.split(",")]
    if not all(p in PLATFORMS for p in platforms):
        raise ValueError(f"--export_platforms {opt.export_platforms!r}: expected names "
                         f"from {', '.join(PLATFORMS)}")
    return platforms


def export_device(opt) -> torch.device:
    """The device ``--gpu_ids`` asks for (``options.serving_devices``, the
    first), checked against ``--export_platforms``."""
    platforms = parse_platforms(opt)
    device = serving_devices(opt)[0]
    if device.type not in {PLATFORMS[p] for p in platforms}:
        raise ValueError(f"--export_platforms {opt.export_platforms} does not name "
                         f"{device.type}, which --gpu_ids gives ({device}; -1 is the CPU)")
    return device


def export_inference(opt) -> torch.export.ExportedProgram:
    """Build and restore the generator per ``opt`` and export the serving
    chain at (``export_batch``, ``segment_length``) float32 on
    ``export_device(opt)``."""
    device = export_device(opt)
    cfg = spectral_config_from_opt(opt)
    generator = build_generator(opt)
    state, _ = load_generator_state(opt, generator)
    generator.load_state_dict(state, strict=True)
    # a serving program: no gradient reaches the weights (K1 and K2 are forward-only)
    generator = generator.to(device).eval().requires_grad_(False)
    program = ServingProgram(InferenceModule(generator, SpectralTransform(cfg, device),
                                             out_length=cfg.segment_length))
    example = torch.zeros((opt.export_batch, cfg.segment_length), device=device)
    with float32_policy():
        return torch.export.export(program, (example,), strict=False)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the CLI on ``argv`` (``sys.argv`` when None).  Returns the
    program's ``path``, its ``bytes``, ``export_s`` (build, restore,
    export and any move of the state, by the host clock), its export
    ``device`` and its ``platforms``."""
    opt = TrainOptions().parse(argv, save=False)
    if not opt.export_path:
        raise SystemExit("--export_path is required")
    device = export_device(opt)
    platforms = parse_platforms(opt)
    t0 = time.perf_counter()
    program = export_inference(opt)
    if device.type == "cuda" and "cpu" in {PLATFORMS[p] for p in platforms}:
        # a host without a card reads the state from the CPU
        program = move_to_device_pass(program, "cpu")
    export_s = time.perf_counter() - t0
    torch.export.save(program, opt.export_path, extra_files={RECORD: json.dumps(platforms)})
    size = os.path.getsize(opt.export_path)
    print(f"wrote {size} bytes of torch.export program ({','.join(platforms)}, exported "
          f"on {device}, batch {opt.export_batch}) to {opt.export_path}")
    return {"path": opt.export_path, "bytes": size, "export_s": export_s,
            "device": str(device), "platforms": platforms}


if __name__ == "__main__":
    main()
