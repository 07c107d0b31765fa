"""Export a checkpoint of the port's train CLI as reference ``.pth`` files:
the port of ``mdctgan_tpu/export_torch_cli.py``.

    python -m mdctgan_tpu_torch.export_torch_cli --load_pretrain RUN_DIR \\
        --export_dir OUT [--which_epoch latest | N] [--export_step STEP] \\
        ...the run's model flags...

``RUN_DIR`` is a run of ``python -m mdctgan_tpu_torch.train_cli`` (its
``ckpt/``).  The save is ``--export_step`` or, without it, ``--which_epoch``
resolved through the epoch index (``latest`` the newest save).  The CLI
writes ``<which_epoch>_net_G.pth`` and ``<which_epoch>_net_D.pth`` in the
reference's ``nn.Sequential`` key layout, which the reference, the JAX
package's importer and this package's ``generate_cli`` load.

The weights are read from the checkpoint onto the host and written from
there: nothing runs on any device, so ``--gpu_ids`` is not read.  This is
the whole of the CLI's work, not a fallback from the card.  A parameter of
the model that the flags build and the save lacks (or holds at another
shape) raises with its name: no value is made up for it.
"""

from __future__ import annotations

import os
from typing import List, Mapping, Optional, Sequence

import torch

from mdctgan_tpu_torch.models.discriminator import build_discriminator
from mdctgan_tpu_torch.models.generator import build_generator
from mdctgan_tpu_torch.options import TrainOptions
from mdctgan_tpu_torch.train.checkpoint import CheckpointManager
from mdctgan_tpu_torch.train.import_torch import (
    discriminator_entries,
    export_to_torch_keys,
    generator_entries_for,
)


def export_state_to_pth(g_state: Mapping[str, torch.Tensor],
                        d_state: Mapping[str, torch.Tensor], generator: torch.nn.Module,
                        opt, out_dir: str, label: str = "latest") -> List[str]:
    """Write ``<label>_net_G.pth`` and ``<label>_net_D.pth`` from the port's
    state dicts of G (for ``generator``'s architecture) and D; returns the
    paths written."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name, state, entries in (
            ("G", g_state, generator_entries_for(generator)),
            ("D", d_state, discriminator_entries(opt.num_D, opt.n_layers_D))):
        sd = {k: v.to(torch.float32).contiguous()
              for k, v in export_to_torch_keys(state, entries).items()}
        path = os.path.join(out_dir, f"{label}_net_{name}.pth")
        torch.save(sd, path)
        written.append(path)
    return written


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Run the CLI on ``argv`` (``sys.argv`` when None); returns the paths
    written."""
    parser = TrainOptions()
    parser.initialize()
    parser.parser.add_argument("--export_dir", type=str, required=True,
                               help="directory to write <which_epoch>_net_{G,D}.pth into")
    parser.parser.add_argument("--export_step", type=int, default=None,
                               help="the checkpoint step to export (default: --which_epoch "
                                    "through the epoch index; 'latest' the newest save)")
    opt = parser.parse(argv, save=False)
    if not opt.load_pretrain:
        raise SystemExit("--load_pretrain (a run directory of the port's train CLI) "
                         "is required")
    generator, discriminator = build_generator(opt), build_discriminator(opt)
    mgr = CheckpointManager(os.path.join(opt.load_pretrain, "ckpt"))
    step = opt.export_step if opt.export_step is not None else mgr.resolve_epoch(opt.which_epoch)
    sub = mgr.restore_fields({"generator": generator.state_dict(),
                              "discriminator": discriminator.state_dict()}, step=step)
    mgr.close()
    print(f"restored step {step}")
    paths = export_state_to_pth(sub["generator"], sub["discriminator"], generator, opt,
                                opt.export_dir, opt.which_epoch)
    for path in paths:
        print(f"wrote {path}")
    return paths


if __name__ == "__main__":
    main()
