"""Generator weights for the inference entry points: the ``.pth`` branch of
``mdctgan_tpu/train/restore.py``.

``--load_pretrain DIR`` holds the reference's ``<which_epoch>_net_G.pth``
(or one that ``mdctgan_tpu/export_torch_cli.py`` wrote from a JAX model).
The JAX package's own ``ckpt/`` directories are orbax checkpoints, which the
port cannot read without JAX; its own checkpoint format is not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from mdctgan_tpu_torch.options import as_dict
from mdctgan_tpu_torch.train import import_torch


def load_generator_state(opt, generator: nn.Module) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """``<load_pretrain>/<which_epoch>_net_G.pth`` -> (a ``state_dict`` that
    ``generator`` loads strictly, the fallback rungs taken; see
    ``import_torch.import_generator``).  What the file does not carry keeps
    ``generator``'s current values.  Raises ``SystemExit`` when there is no
    such file."""
    o = as_dict(opt)
    pretrain = o.get("load_pretrain", "")
    if not pretrain:
        raise SystemExit("--load_pretrain is required (no weights to run)")
    path = os.path.join(pretrain, f"{o.get('which_epoch', 'latest')}_net_G.pth")
    if not os.path.exists(path):
        if os.path.isdir(os.path.join(pretrain, "ckpt")):
            raise SystemExit(
                f"{pretrain} holds an orbax ckpt/ directory of the JAX package, which "
                "the port cannot read; it reads <epoch>_net_G.pth files until its own "
                "checkpoint format is ported (ROADMAP Queue 1 item 14). Export one with "
                "python -m mdctgan_tpu.export_torch_cli.")
        raise SystemExit(f"no generator weights at {path}")
    state, rungs = import_torch.import_generator(
        import_torch.load_pth(path), generator,
        param_key_map=o.get("param_key_map") or None)
    print(f"imported pretrained G from {path}"
          + (f" (fallback: {', '.join(rungs)})" if rungs else ""))
    return state, rungs
