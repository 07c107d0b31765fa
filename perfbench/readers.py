"""The arithmetic of the metric readers (``metrics/<name>.py``): each reads
a run's ``harness.Record`` and returns a number, or None where the run
holds nothing to read (a reader never returns 0 for a share it could not
read)."""

from __future__ import annotations

import statistics
from typing import Optional

from perfbench import roofline, stats

K1, K2 = "mdct_spectro", "imdct_audio"


def mean_ms(rec, span: str) -> Optional[float]:
    values = rec.spans.get(span)
    return statistics.fmean(values) * 1e3 if values else None


def mfu(rec, work_items: float) -> Optional[float]:
    """The window's model FLOPs over its time, a share of the card's bf16
    peak, in %."""
    if rec.peaks is None or not work_items or not rec.window_s:
        return None
    return 100.0 * rec.flops_per_item * work_items / rec.window_s / rec.peaks["bf16"]


def roofline_share(rec, kernel: str) -> Optional[float]:
    """The kernel's least time at the rows it was given (``roofline.py``),
    over its device time in the trace, in %."""
    if rec.trace is None or rec.peaks is None or kernel not in rec.shapes:
        return None
    seconds, count = rec.trace.kernel(f"{kernel}_")
    if not count or seconds <= 0:
        return None
    bound = roofline.k1_bound_s if kernel == K1 else roofline.k2_bound_s
    return 100.0 * bound(*rec.shapes[kernel], rec.peaks) * count / seconds


def device_idle(rec) -> Optional[float]:
    tr = rec.trace
    if tr is None or not tr.device or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def generator_ms_per_batch(rec) -> Optional[float]:
    """Device time of every kernel in the trace but K1 and K2, over the
    batches (K1's launches) in it."""
    tr = rec.trace
    if tr is None:
        return None
    k1_s, batches = tr.kernel(f"{K1}_")
    if not batches:
        return None
    return (tr.kernels_s() - k1_s - tr.kernel(f"{K2}_")[0]) / batches * 1e3


def p95_ms(rec) -> Optional[float]:
    return stats.percentile(rec.latencies_s, 95) * 1e3 if rec.latencies_s else None
