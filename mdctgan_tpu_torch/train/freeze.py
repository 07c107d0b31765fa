"""Parameter freezing: the port of ``mdctgan_tpu/train/freeze.py``.

``param_labels`` labels each parameter ``"train"`` or ``"frozen"`` by its
dotted name (the Flax path joined with dots); ``masked_optimizer`` leaves
the frozen ones out of the optimizer, which updates them as
``optax.set_to_zero`` does: not at all.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

from mdctgan_tpu_torch.train.schedule import OptimizerSpec

# The reference freezes by layer class: freeze_global_d toggles the stem,
# the downsample convs and the final head conv; freeze_global_u the
# upsample, resblock and attention classes.
_GLOBAL_DOWN = ("stem", "down", "head")
_GLOBAL_UP = ("res", "attn", "up")


def param_labels(
    names: Iterable[str],
    freeze_g_d: bool = False,
    freeze_g_u: bool = False,
    freeze_l_d: bool = False,
    freeze_l_u: bool = False,
    fix_global: bool = False,
) -> Dict[str, str]:
    """``{name: "train" | "frozen"}`` for a generator's parameter names.

    A LocalEnhancer has a ``global`` branch beside ``local_*`` modules; a
    bare GlobalGenerator has ``stem``/``down*``/``res*``/``attn``/``up*``/
    ``head`` at the top.  ``fix_global`` freezes everything but the enhancer
    branch.  Within the enhancer the reference freezes whole stages: only
    ``local_stem``/``local_down`` belong to the down group, every other
    ``local_*`` module (the head included) to the up group."""

    def label(name: str) -> str:
        parts = name.split(".")
        is_local = "local" in parts[0]
        if fix_global and not is_local:
            return "frozen"
        if is_local:
            down = parts[0].endswith(("local_stem", "local_down"))
            return "frozen" if (freeze_l_d if down else freeze_l_u) else "train"
        sub = parts[1] if parts[0] == "global" else parts[0]
        if sub.startswith(_GLOBAL_DOWN) and freeze_g_d:
            return "frozen"
        if sub.startswith(_GLOBAL_UP) and freeze_g_u:
            return "frozen"
        return "train"

    return {n: label(n) for n in names}


def masked_optimizer(tx: OptimizerSpec, labels: Dict[str, str]) -> OptimizerSpec:
    return dataclasses.replace(tx, labels=labels)
