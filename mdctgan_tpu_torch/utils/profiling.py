"""Reading a ``torch.profiler`` trace of the card: the counterpart of
``mdctgan_tpu/utils/profiling.py``, which reads the JAX profiler's XPlane.

  * ``busy_time_ms``: the union of the device records' intervals (kernels,
    copies, sets; annotations left out), so records that overlap count
    once: the card's busy time, without its idle gaps;
  * ``step_device_time_ms``: the span from the first device record's start
    to the last one's end, per step: busy time plus the idle inside it;
  * ``report``: both per step, the idle share, and the kernels that took
    the most device time.

Each returns None where the trace holds no device record (a run on the
CPU).
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def device_intervals(prof) -> List[Tuple[float, float]]:
    """(start, end) in microseconds of every device record of ``prof``."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))


def busy_time_ms(prof, steps: int = 1) -> Optional[float]:
    spans = device_intervals(prof)
    if not spans:
        return None
    busy, reach = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    return busy / 1e3 / steps


def step_device_time_ms(prof, steps: int = 1) -> Optional[float]:
    spans = device_intervals(prof)
    if not spans:
        return None
    return (max(b for _, b in spans) - spans[0][0]) / 1e3 / steps


def report(prof, steps: int, wall_ms: Optional[float] = None, top: int = 15) -> dict:
    """Print and return the busy and spanned device time per step, the idle
    share of ``wall_ms`` (the host's time for the ``steps``, when given)
    and the ``top`` kernels by device time per step."""
    busy, span = busy_time_ms(prof, steps), step_device_time_ms(prof, steps)
    out = {"steps": steps, "device_busy_ms": busy, "device_span_ms": span,
           "device_records": len(device_intervals(prof)), "wall_ms": wall_ms,
           "device_idle_share": (1.0 - busy * steps / wall_ms
                                 if busy is not None and wall_ms else None),
           "top": []}
    if busy is None:
        print("profile: no device record (a run on the CPU)")
        return out
    from torch.autograd import DeviceType

    # device records only: a host operation traced beside them also carries
    # the device time of the kernels it launched
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)[:top]
    out["top"] = [{"name": e.key[:90], "count": e.count / steps,
                   "ms": e.self_device_time_total / 1e3 / steps} for e in kernels]
    print(f"per step: {busy:.1f} ms busy, {span:.1f} ms spanned on the device"
          + (f", idle {out['device_idle_share']:.1%} of {wall_ms / steps:.1f} ms"
             if wall_ms else ""))
    print(f"top {len(kernels)} kernels by device time (per step):")
    for k in out["top"]:
        print(f"  {k['ms']:8.3f} ms {k['count']:8.1f}x  {k['name']}")
    return out
