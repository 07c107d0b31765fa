"""What the drivers share: the device's clock, the traced stretch and the
spans at the train step's marks."""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import Callable, Dict, List

import torch

from perfbench.trace import Trace


class Phases:
    """Seconds of each part of the set-up, by the host clock from the
    process's start; printed to standard error."""

    def __init__(self, t0: float):
        self.last, self.parts = t0, {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = round(now - self.last, 3)
        self.last = now

    def report(self) -> None:
        print(f"setup parts (s): {self.parts}", file=sys.stderr, flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def annotate(name: str, on: bool):
    """A named host range in the trace (``torch.profiler.record_function``)
    in a traced run; nothing otherwise."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def reference_precision() -> None:
    """Full float32 for the reference: TF32 off in cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Marks:
    """Device timestamps at the train step's ``mark(name)`` points
    (``train/step.py``): a CUDA event at the step's start and at each mark,
    read once the window has synchronised; the host clock off the card."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.steps: List[List[tuple]] = []

    def _stamp(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def begin(self) -> None:
        self.steps.append([("start", self._stamp())])

    def mark(self, name: str) -> None:
        self.steps[-1].append((name, self._stamp()))

    def spans(self) -> Dict[str, List[float]]:
        """Seconds from each mark's predecessor, per step, by mark name."""
        out: Dict[str, List[float]] = {}
        for stamps in self.steps:
            for (_, a), (name, b) in zip(stamps, stamps[1:]):
                dt = a.elapsed_time(b) / 1e3 if self.cuda else b - a
                out.setdefault(name, []).append(dt)
        return out


def traced(device, one: Callable[[], None], items: int, label_items: int) -> Trace:
    """The traced stretch, run right after the window on the same state and
    feed: ``items`` calls of ``one`` under the profiler with the device's
    activity only (the busy time, the kernels; the host's launches barely
    slowed), synchronised at both ends; then ``label_items`` calls with the
    host's activity too, whose idle gaps are named by what the host was
    doing (``Trace.idle_gaps``)."""
    from torch.profiler import ProfilerActivity, profile

    cpu, cuda = ProfilerActivity.CPU, ProfilerActivity.CUDA

    def run(activities, n):
        sync(device)
        prof = profile(activities=activities)
        prof.start()
        t0 = time.perf_counter()
        for _ in range(n):
            one()
        sync(device)
        window_s = time.perf_counter() - t0
        prof.stop()
        return prof, window_s

    main = Trace.from_profiler(*run([cuda] if device.type == "cuda" else [cpu], items))
    main.labelled = Trace.from_profiler(*run([cpu, cuda] if device.type == "cuda" else [cpu],
                                             label_items))
    return main
