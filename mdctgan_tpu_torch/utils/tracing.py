"""Spans and counters inside the port.

  * ``span(name)``: a context manager around one part of the work.  Off,
    it returns one shared null context: no allocation, no clock read, no
    torch call.  While ``enable()`` is in force it records the part in
    memory (``Span``: its name, its root's id and its start and end on
    ``time.perf_counter_ns``); every span of a step or a request shares
    the id of its outermost span, tracked per thread.  Whenever a
    ``torch.profiler`` is recording, enabled or not, it also enters
    ``torch.profiler.record_function(name)``, so the part lands on the
    profiler's timeline beside the card's records (a device idle gap can
    be put down to the innermost span the host was in).
  * ``count(name, n=1)``: adds to ``COUNTERS``, always on, as the kernel
    wrappers' ``mdct_kernels.LAUNCHES`` are; ``snapshot()`` copies them.
  * ``collect()``: the recorded spans, cleared.  The recorder keeps every
    span until then: whoever enables it collects once a window.

PERF.md §3 lists the spans and counters the port holds and what reads each.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple

import torch
import torch.autograd.profiler as _profiler

COUNTERS: Dict[str, int] = {}

_NULL = contextlib.nullcontext()
_enabled = False
_spans: List["Span"] = []
_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()  # this thread's open recorded spans and their root


class Span(NamedTuple):
    name: str
    root: int  # shared by every span of one step or request
    start_ns: int
    end_ns: int


class _Recorded:
    __slots__ = ("name", "note", "root", "start")

    def __init__(self, name: str, note):
        self.name, self.note = name, note

    def __enter__(self):
        depth = getattr(_local, "depth", 0)
        if not depth:
            _local.root = next(_ids)
        _local.depth = depth + 1
        self.root = _local.root
        if self.note is not None:
            self.note.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.note is not None:
            self.note.__exit__(*exc)
        _local.depth -= 1
        with _lock:
            _spans.append(Span(self.name, self.root, self.start, end))


def span(name: str):
    """A context manager around one part of the work (the module's
    docstring)."""
    profiling = _profiler._is_profiler_enabled
    if not (_enabled or profiling):
        return _NULL
    note = torch.profiler.record_function(name) if profiling else None
    return _Recorded(name, note) if _enabled else note


def count(name: str, n: int = 1) -> None:
    with _lock:
        COUNTERS[name] = COUNTERS.get(name, 0) + n


def snapshot() -> Dict[str, int]:
    """A copy of the counters."""
    with _lock:
        return dict(COUNTERS)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def collect() -> List[Span]:
    """The spans recorded since the last ``collect()``, in the order they
    ended; the store is cleared."""
    with _lock:
        out = list(_spans)
        _spans.clear()
    return out
