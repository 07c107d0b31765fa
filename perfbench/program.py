"""What the metric readers read of the port's own counters
(``mdctgan_tpu_torch/utils/tracing.py``).

The counters are the process's: read once the run has finished, they cover
all it did, set-up (the checked train steps and the input queue's first
fill, or the warm-up requests), the window and both traced stretches, and
not the window alone.  The port's spans enter the traced stretch's trace as
host annotations (``torch.profiler.record_function``); a reader looks there
only to see which path a run took.

A program without the counters (the port before them) gives nothing to
read: each function here then returns None, and never raises.
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional


def annotated(rec, name: str) -> bool:
    """Whether the stretch that traced the host holds an annotation ``name``."""
    tr = rec.trace
    return tr is not None and any(s.name == name for s in (tr.labelled or tr).annotations)


def counters() -> Optional[Dict[str, int]]:
    """The port's counters, or None where it has none."""
    try:
        tracing = importlib.import_module("mdctgan_tpu_torch.utils.tracing")
    except ImportError:
        return None
    return tracing.snapshot()


def ratio(numerator: str, denominator: str) -> Optional[float]:
    c = counters()
    if c is None or not c.get(denominator):
        return None
    return c.get(numerator, 0) / c[denominator]
