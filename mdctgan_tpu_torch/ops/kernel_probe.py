"""Times of the transform kernels on one GPU.

    python3 -m mdctgan_tpu_torch.ops.kernel_probe [ROOT ...]

Measures nothing on the port's path; it is the tool for comparing kernel
versions and for seeing where K1's time goes.

* For each ROOT (a checkout of this repository whose ``mdctgan_tpu_torch``
  has the wrappers of ``ops/mdct_kernels.py``), in the order given: the
  mean device time (``torch.profiler``, over 50 calls) of the kernel the
  wrappers launch for K1 and for K2: the FFT form at n_fft 512, batches 8
  and 20, and the dense form (``mdct_spectro_dense``,
  ``imdct_audio_dense``) at n_fft 512 and 960, batches 8, 16 and 20.  To
  compare two trees, give them as ``A B B A`` so that both are measured
  early and late in the call.
* For this checkout: each dense form at those shapes as CUDA-graph replays
  (``graph_us``: 10 calls a graph, the median of 25 replays by CUDA
  events), as eager calls (``eager_us``) and as device time, beside the
  library ``torch.matmul`` of the same product (the framed signal times
  the (N, N/2) matrix; the spectrum times the (N/2, N) matrix) and the
  plain version; and K1's FFT form cut into parts by ``csrc/k1_parts.cu``
  (an empty kernel of K1's grid, the staging alone, the transform without
  its epilogue, the whole kernel).

Each result is one JSON line; times are in microseconds.  A segment is 127
hops (128 frames), as the flagship's 32512 samples at n_fft 512.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

GAIN, T, BATCHES, CALLS = 1000.0, 32512, (8, 20), 50
DENSE_NS, DENSE_BATCHES = (512, 960), (8, 16, 20)


def device_us(fns: dict, calls: int = CALLS) -> dict:
    """Mean device time (us) of the one kernel each function launches: the
    mean over the kernel records the profiler kept, since it may drop some
    when a process opens many profiling windows."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        out[name] = (sum(e.self_device_time_total for e in kernels)
                     / sum(e.count for e in kernels))
    return out


def graph_us(fn, runs: int = 25, inner: int = 10) -> float:
    """The card's time for one call: ``inner`` calls captured in one CUDA
    graph, replayed ``runs`` times between CUDA events; the median of the
    mean per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / inner)
    return statistics.median(times)


def eager_us(fn, runs: int = 25, inner: int = 10) -> float:
    """As ``graph_us`` for back-to-back eager calls: adds the host's launch
    cost."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / inner)
    return statistics.median(times)


def _kernels_of(root: Path):
    """``ops.mdct_kernels`` imported from the checkout at ``root``."""
    for mod in [m for m in sys.modules if m.split(".")[0] == "mdctgan_tpu_torch"]:
        del sys.modules[mod]
    sys.path.insert(0, str(root))
    try:
        return importlib.import_module("mdctgan_tpu_torch.ops.mdct_kernels")
    finally:
        sys.path.pop(0)


def _inputs(b: int, dev):
    rng = np.random.default_rng(b)
    x = torch.from_numpy(rng.standard_normal((b, T)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.uniform(-1, 1, (b, 128, 256)).astype(np.float32)).to(dev)
    return x, y


def _dense_inputs(n: int, b: int, dev):
    """A segment of 127 hops of noise and a (b, 128, n/2) normalised
    spectrum."""
    rng = np.random.default_rng(n + b)
    x = torch.from_numpy(rng.standard_normal((b, 127 * (n // 2))).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.uniform(-1, 1, (b, 128, n // 2)).astype(np.float32)).to(dev)
    return x, y


def tree_times(root: Path, dev) -> dict:
    K = _kernels_of(root)
    mat, syn = K.spectro_matrix(512, dev), K.synth_matrix(512, dev)
    times = {}
    for b in BATCHES:
        x, y = _inputs(b, dev)
        for name, us in device_us({
            "mdct_spectro": lambda: K.mdct_spectro(x, mat, GAIN, 0.2, 0.0),
            "imdct_audio": lambda: K.imdct_audio(y, syn, GAIN, 5.0, 0.0),
        }).items():
            times[f"{name}@{b}"] = us
    for n in DENSE_NS:
        mat, syn = K.spectro_matrix(n, dev), K.synth_matrix(n, dev)
        for b in DENSE_BATCHES:
            x, y = _dense_inputs(n, b, dev)
            for name, us in device_us({
                "mdct_spectro_dense": lambda: K.mdct_spectro_dense(x, mat, GAIN, 0.2, 0.0),
                "imdct_audio_dense": lambda: K.imdct_audio_dense(y, syn, GAIN, 5.0, 0.0),
            }).items():
                times[f"{name}@{n}x{b}"] = us
    return times


def dense_table(dev) -> list:
    """Each dense form of this checkout beside the library product and its
    plain version at ``DENSE_NS`` x ``DENSE_BATCHES``."""
    from mdctgan_tpu_torch.ops import mdct_kernels as K
    from mdctgan_tpu_torch.ops.mdct import frame_signal

    rows = []
    for n in DENSE_NS:
        mat, syn = K.spectro_matrix(n, dev), K.synth_matrix(n, dev)
        for b in DENSE_BATCHES:
            x, y = _dense_inputs(n, b, dev)
            frames = frame_signal(x, n, n // 2).reshape(-1, n).contiguous()
            spec2d = y.reshape(-1, n // 2)
            for name, fn, lib, plain in (
                ("mdct_spectro_dense", lambda: K.mdct_spectro_dense(x, mat, GAIN, 0.2, 0.0),
                 lambda: torch.matmul(frames, mat),
                 lambda: K.mdct_spectro_plain(x, mat, GAIN, 0.2, 0.0)),
                ("imdct_audio_dense", lambda: K.imdct_audio_dense(y, syn, GAIN, 5.0, 0.0),
                 lambda: torch.matmul(spec2d, syn),
                 lambda: K.imdct_audio_plain(y, syn, GAIN, 5.0, 0.0)),
            ):
                rows.append({
                    "name": name, "n_fft": n, "batch": b,
                    "graph_us": graph_us(fn), "eager_us": eager_us(fn),
                    "device_us": device_us({name: fn})[name],
                    "library_graph_us": graph_us(lib), "library_eager_us": eager_us(lib),
                    "plain_graph_us": graph_us(plain)})
                print(json.dumps({"dense": rows[-1]}), flush=True)
    return rows


def k1_parts(dev) -> dict:
    from mdctgan_tpu_torch.ops import mdct_kernels as K
    from mdctgan_tpu_torch.ops._build import load_library

    fn = load_library("k1_parts").k1_parts_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [i, p, p, p, i, ctypes.c_longlong, i, f, f, f, p]
    fn.restype = ctypes.c_int
    tables = K.fft_tables(512, dev)
    mat = K.spectro_matrix(512, dev)
    parts = {}
    for b in BATCHES:
        x, _ = _inputs(b, dev)
        n_frames = K.n_frames(T, 512, 256)
        out = torch.empty((b, n_frames, 256), device=dev)

        def launch(part):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(part, x.data_ptr(), tables.data_ptr(), out.data_ptr(), b, T,
                     n_frames, GAIN, 0.2, 0.0, stream)
            if err:
                raise RuntimeError(f"k1_parts_launch failed with CUDA error {err}")

        launch(3)
        torch.cuda.synchronize()
        err = float((out - K.mdct_spectro(x, mat, GAIN, 0.2, 0.0)).abs().max())
        if err > 1e-6:
            raise AssertionError(f"k1_parts part 3 differs from K1 by {err}")
        names = ("empty", "staging", "transform", "whole")
        parts[b] = device_us({n: (lambda p=p: launch(p)) for p, n in enumerate(names)})
    return parts


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from mdctgan_tpu_torch.device import float32_policy

    dev = torch.device("cuda")
    here = Path(__file__).resolve().parents[2]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": smi}), flush=True)
    with float32_policy():  # the library products in full float32, no TF32
        for root in [Path(a).resolve() for a in argv] or [here]:
            print(json.dumps({"tree": str(root.relative_to(here)) if root.is_relative_to(here)
                              else str(root), "device_us": tree_times(root, dev)}), flush=True)
        _kernels_of(here)
        dense_table(dev)
        print(json.dumps({"k1_parts_us": k1_parts(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
