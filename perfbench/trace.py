"""Reading a ``torch.profiler`` trace of the card.

The busy time is the union of the device records' intervals (kernels,
copies, sets), so records that overlap count once: a frozen copy of the
port's ``utils/profiling.py`` arithmetic.  Beside it: device time and
count by kernel name, the operations that took the most device time, and
the device's idle gaps, each named by what the host was doing when the
device went idle (the harness's annotation and the innermost host
operation at the gap's start).
"""

from __future__ import annotations

import bisect
import collections
from typing import List, NamedTuple, Optional, Sequence, Tuple


class Record(NamedTuple):
    start: float  # microseconds
    end: float
    name: str


COPY_PREFIXES = ("Memcpy", "Memset")


def union_us(spans: Sequence[Tuple[float, float]]) -> float:
    busy, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    return busy


class Trace:
    """Device records and host records of a traced stretch of
    ``window_s`` seconds of host time (synchronised at both ends)."""

    def __init__(self, device: Sequence[Record], host: Sequence[Record],
                 annotations: Sequence[Record], window_s: float):
        self.device = sorted(device)
        self.host = sorted(host)
        self.annotations = sorted(annotations)
        self.window_s = window_s
        # a second trace of the same loop with the host's activity, which
        # names the idle gaps (``drivers/common.traced``)
        self.labelled: Optional["Trace"] = None

    @classmethod
    def from_profiler(cls, prof, window_s: float) -> "Trace":
        from torch.autograd import DeviceType

        device, host, notes = [], [], []
        for e in prof.events():
            rec = Record(e.time_range.start, e.time_range.end, e.name)
            if getattr(e, "is_user_annotation", False):
                if e.device_type == DeviceType.CPU:
                    notes.append(rec)
            elif e.device_type == DeviceType.CUDA:
                device.append(rec)
            elif e.device_type == DeviceType.CPU:
                host.append(rec)
        return cls(device, host, notes, window_s)

    @property
    def busy_s(self) -> float:
        return union_us([(r.start, r.end) for r in self.device]) / 1e6

    def kernel(self, pattern: str) -> Tuple[float, int]:
        """(device seconds, records) of the kernels whose name holds
        ``pattern``."""
        hits = [r for r in self.device if pattern in r.name]
        return sum(r.end - r.start for r in hits) / 1e6, len(hits)

    def kernels_s(self) -> float:
        """Device seconds of every kernel (copies and sets left out)."""
        return sum(r.end - r.start for r in self.device
                   if not r.name.startswith(COPY_PREFIXES)) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        total = collections.Counter()
        for r in self.device:
            total[r.name[:120]] += (r.end - r.start) / 1e6
        return [[k, v] for k, v in total.most_common(n)]

    def _innermost(self, records: Sequence[Record], t: float) -> Optional[str]:
        """The latest-starting record of ``records`` (sorted) that covers
        ``t``: the innermost of nested host ranges."""
        i = bisect.bisect_right(records, Record(t, float("inf"), "")) - 1
        for j in range(i, max(i - 4096, -1), -1):
            if records[j].end >= t:
                return records[j].name
        return None

    def gaps(self) -> List[Tuple[float, float]]:
        """The device's idle intervals between its first and last record."""
        out, reach = [], None
        for r in self.device:
            if reach is not None and r.start > reach:
                out.append((reach, r.start))
            reach = r.end if reach is None else max(reach, r.end)
        return out

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle seconds by what the host was doing at each gap's start,
        the most first."""
        total = collections.Counter()
        for a, b in self.gaps():
            note = self._innermost(self.annotations, a) or "-"
            op = self._innermost(self.host, a) or "python"
            total[f"{note}/{op}"[:120]] += (b - a) / 1e6
        return [[k, v] for k, v in total.most_common(n)]

    def breakdown(self) -> dict:
        named = self.labelled if self.labelled is not None else self
        return {"device_ops": self.top_ops(10), "idle_gaps": named.idle_gaps(10)}
