"""Times of the transform kernels on one GPU.

    python3 probes/kernel_probe.py [ROOT ...]

Measures nothing on the port's path; it is the tool for comparing kernel
versions and for seeing where K1's time goes.  ``chip_smoke.py`` phase 7
gives each kernel beside its plain version, the library product and its
bound; this probe times with phase 7's timers.

* For each ROOT (a checkout of this repository whose ``mdctgan_tpu_torch``
  has the wrappers of ``ops/mdct_kernels.py``), in the order given: the
  mean device time (``chip_smoke.device_ms``, over 50 calls) of the kernel
  the wrappers launch for K1 and for K2: the FFT form at n_fft 512,
  batches 8 and 20, and the dense form (``mdct_spectro_dense``,
  ``imdct_audio_dense``) at n_fft 512 and 960, batches 8, 16 and 20.  To
  compare two trees, give them as ``A B B A`` so that both are measured
  early and late in the call.
* For this checkout: K1's FFT form cut into parts by ``csrc/k1_parts.cu``
  (an empty kernel of K1's grid, the staging alone, the transform without
  its epilogue, the whole kernel), each part's device time the same way.

Each result is one JSON line; times are in ms.  A segment is 127 hops (128
frames), as the flagship's 32512 samples at n_fft 512.  Run it from the
repository root on a machine with one CUDA device.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import device_ms  # noqa: E402  (phase 7's timer)

GAIN, T, BATCHES, CALLS = 1000.0, 32512, (8, 20), 50
DENSE_NS, DENSE_BATCHES = (512, 960), (8, 16, 20)


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
        times[f"mdct_spectro@{b}"] = device_ms(
            lambda: K.mdct_spectro(x, mat, GAIN, 0.2, 0.0), CALLS)
        times[f"imdct_audio@{b}"] = device_ms(
            lambda: K.imdct_audio(y, syn, GAIN, 5.0, 0.0), CALLS)
    for n in DENSE_NS:
        mat, syn = K.spectro_matrix(n, dev), K.synth_matrix(n, dev)
        for b in DENSE_BATCHES:
            x, y = _dense_inputs(n, b, dev)
            times[f"mdct_spectro_dense@{n}x{b}"] = device_ms(
                lambda: K.mdct_spectro_dense(x, mat, GAIN, 0.2, 0.0), CALLS)
            times[f"imdct_audio_dense@{n}x{b}"] = device_ms(
                lambda: K.imdct_audio_dense(y, syn, GAIN, 5.0, 0.0), CALLS)
    return times


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
        parts[b] = {n: device_ms(lambda p=p: launch(p), CALLS) for p, n in enumerate(names)}
    return parts


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from mdctgan_tpu_torch.device import float32_policy

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": smi}), flush=True)
    with float32_policy():
        for root in [Path(a).resolve() for a in argv] or [ROOT]:
            print(json.dumps({"tree": str(root.relative_to(ROOT)) if root.is_relative_to(ROOT)
                              else str(root), "device_ms": tree_times(root, dev)}), flush=True)
        _kernels_of(ROOT)
        print(json.dumps({"k1_parts_ms": k1_parts(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
