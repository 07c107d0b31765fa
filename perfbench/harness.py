"""One run of one cell: find the cell's files by name, check the card,
run the cell's driver (set-up, window, check), read the cell's metrics and
print the result line.

The result line, the last line of standard output, holds ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "mdctgan_tpu"})


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & FORBIDDEN)


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file found by name (``metrics/k1_roofline.train.py``
    and the like, whose names hold dots)."""
    spec = importlib.util.spec_from_file_location(f"perfbench_file_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""

    root: Path
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def driver(self):
        name = self.traffic["driver"]
        return load_module(self.root / "perfbench" / "drivers" / f"{name}.py", f"driver_{name}")

    def metrics(self, trace: bool) -> List[dict]:
        return [m for m in (self.per_layer if trace else self.end_to_end)
                if self.name in m.get("workloads", [self.name])]


def find_cell(root: Path, name: str) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise SystemExit(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    config = next(c for c in bench["configs"] if c["name"] == workload["config"])
    return Cell(root, name, workload, load_json(root / config["file"]),
                load_json(root / "perfbench" / "traffic" / f"{workload['traffic']}.json"),
                bench["end_to_end"], bench["per_layer"])


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments and the device."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float  # host clock at the process's start


@dataclasses.dataclass
class Record:
    """What a driver hands back: what the window did and what the check
    found.  Metric readers (``metrics/<name>.py``) read it."""

    kind: str
    setup_s: float = math.nan
    window_s: float = math.nan
    items: int = 0  # train steps or requests in the window
    samples: int = 0  # train samples in the window
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    audio_out_s: float = 0.0
    segments: int = 0  # real (unpadded) segments served in the window
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    flops_per_item: float = math.nan  # a train step's, or a segment's
    shapes: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    peaks: Optional[dict] = None
    trace: Any = None
    memory_peak_bytes: int = 0
    correct: bool = False
    failed: int = 0
    checks: Dict[str, dict] = dataclasses.field(default_factory=dict)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card(chips: int):
    """The first card, or None where the cell's cards are not there."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return None
    return torch.device("cuda", 0)


def run(argv, t0: float, root: Path, device=None) -> int:
    """The run; ``device`` None looks for the card (a test passes one)."""
    args = parse(argv)
    cell = find_cell(root, args.workload)
    if device is None:
        device = card(cell.workload["chips"])
        if device is None:
            print(f"perfbench: {args.workload} needs {cell.workload['chips']} CUDA card(s); "
                  "none found, no result", file=sys.stderr)
            return 2
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), device, t0)
    rec: Record = cell.driver().run(ctx)

    metrics = {}
    for m in cell.metrics(ctx.trace):
        value = load_module(root / "perfbench" / "metrics" / f"{m['name']}.py",
                            m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded modules of JAX or the JAX package: {found}; no result",
              file=sys.stderr)
        return 3

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _kind(device), "count": cell.workload["chips"],
           "memory_peak_bytes": int(rec.memory_peak_bytes)}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    line = {"correct": bool(rec.correct), "attempted": int(rec.items),
            "failed": int(rec.failed), "metrics": metrics, "device": dev}
    if ctx.trace and rec.trace is not None:
        dev["busy_s"], dev["window_s"] = rec.trace.busy_s, rec.trace.window_s
        line["breakdown"] = rec.trace.breakdown()
    line["checks"] = rec.checks
    for name, c in rec.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def _kind(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
