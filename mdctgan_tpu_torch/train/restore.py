"""Generator weights for the inference entry points: the port of
``mdctgan_tpu/train/restore.py``.

``--load_pretrain DIR`` holds the reference's ``<which_epoch>_net_G.pth``
(or one that ``mdctgan_tpu/export_torch_cli.py`` wrote from a JAX model),
or the ``ckpt/`` of a run of the port's train CLI (``train/checkpoint.py``),
from which only the generator's weights are read.  The JAX package's own
``ckpt/`` directories are orbax checkpoints, which the port cannot read
without JAX.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from mdctgan_tpu_torch.options import as_dict
from mdctgan_tpu_torch.train import checkpoint, import_torch


def load_generator_state(opt, generator: nn.Module) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """``<load_pretrain>/<which_epoch>_net_G.pth`` or, without one, the
    port's ``<load_pretrain>/ckpt/`` at ``--which_epoch`` -> (a
    ``state_dict`` that ``generator`` loads strictly, the fallback rungs
    taken; see ``import_torch.import_generator``, and ``[]`` for a
    checkpoint, which must match the architecture exactly).  What a ``.pth``
    does not carry keeps ``generator``'s current values.  Raises
    ``SystemExit`` when there are no weights the port can read."""
    o = as_dict(opt)
    pretrain = o.get("load_pretrain", "")
    if not pretrain:
        raise SystemExit("--load_pretrain is required (no weights to run)")
    which = o.get("which_epoch", "latest")
    path = os.path.join(pretrain, f"{which}_net_G.pth")
    ckpt_dir = os.path.join(pretrain, "ckpt")
    if not os.path.exists(path):
        if checkpoint.is_port_checkpoint(ckpt_dir):
            mgr = checkpoint.CheckpointManager(ckpt_dir)
            step = mgr.resolve_epoch(which)
            state = mgr.restore_fields({"generator": generator.state_dict()}, step=step)
            print(f"restored checkpoint from {pretrain} (step {step})")
            return state["generator"], []
        if os.path.isdir(ckpt_dir):
            raise SystemExit(
                f"{pretrain} holds an orbax ckpt/ directory of the JAX package, which "
                "the port cannot read; it reads <epoch>_net_G.pth files and its own "
                "train CLI's ckpt/. Export one with python -m mdctgan_tpu.export_torch_cli.")
        raise SystemExit(f"no generator weights at {path}")
    state, rungs = import_torch.import_generator(
        import_torch.load_pth(path), generator,
        param_key_map=o.get("param_key_map") or None)
    print(f"imported pretrained G from {path}"
          + (f" (fallback: {', '.join(rungs)})" if rungs else ""))
    return state, rungs
