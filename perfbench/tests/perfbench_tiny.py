"""A copy of the benchmark at a tiny configuration, for the CPU tests: the
real harness, drivers, readers and reference under a temporary root, with
tiny configuration and traffic files and a BENCHMARK.json of tiny cells.

The tiny cells run the port in float32 (bf16 convolutions on the CPU at
these widths only add noise to what the tests check: the harness), so
their limits sit between float32's round-off (losses ~4e-7, gradient norms
~3e-5, spectra ~2e-5, the chaotic change of three Adam steps up to 0.07,
D's first gradient under 1e-5 and its descent 1.1e-4) and what the faults
and the float8 control read (first losses >= 6.6e-4, gradient norms >= 0.2,
spectra >= 0.2, D's gradient >= 0.067 and descent >= 0.004; an unchanged
state 1, a flipped backward or update 2, a loss left out 1)."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = dict(
    n_fft=64, hop_length=32, win_length=64, center=True, bins=32,
    lr_sampling_rate=16000, hr_sampling_rate=48000, sr_sampling_rate=48000,
    segment_length=992, arcsinh_transform=True, arcsinh_gain=1000.0, abs_norm=True,
    src_range=[-5.0, 5.0], norm_range=[-1.0, 1.0], fit_residual=True, abs_spectro=True,
    netG="local", input_nc=2, output_nc=1, ngf=4, n_downsample_global=2,
    n_blocks_global=1, n_blocks_attn_g=1, proj_factor_g=4, heads_g=2, dim_head_g=4,
    n_local_enhancers=1, n_blocks_local=1, n_blocks_attn_l=0,
    downsample_type="resconv", upsample_type="interpolate", fp16=False)

TRAIN = dict(TINY, batchSize=4, nThreads=2, lr=1.5e-4, beta1=0.5, niter=60, niter_decay=60,
             ndf=4, n_layers_D=2, num_D=2, lambda_feat=10.0, no_lsgan=False,
             no_ganFeat_loss=False, pool_size=0, steps_per_epoch=2000)
GENERATE = dict(TINY, batchSize=2, gen_overlap=0)

MIXES = {
    "tiny-corpus": {"driver": "train", "feed": "pipeline",
                    "corpus": {"files": 4, "seconds": 0.2, "rate": 48000},
                    "queue_size": 2, "warmup_steps": 1, "trace_steps": 2, "label_steps": 1,
                    "limits": {"bn_gap": 1e-3, "change_gap": 0.3, "first_loss_gap": 1e-4,
                               "grad_dir.D": 1e-3, "descent.D": 0.01}},
    "tiny-device": {"driver": "train", "feed": "device", "batches": 4,
                    "source_seconds": 0.5, "rate": 48000, "warmup_steps": 1,
                    "trace_steps": 2, "label_steps": 1,
                    "limits": {"bn_gap": 1e-3, "change_gap": 0.3, "first_loss_gap": 1e-4,
                               "grad_dir.D": 1e-3, "descent.D": 0.01}},
    "tiny-requests": {"driver": "generate", "rate": 16000, "lengths_s": [0.01, 0.1],
                      "block": 8, "requests": 64, "pool": {"count": 2, "seconds": 0.5},
                      "warmup_requests": 2, "check_requests": 4, "label_requests": 1,
                      "trace_requests": 3, "limits": {"spectral_gap": 1e-3}},
}
# Metrics that read the input pipeline: the tiny device cell has none.
PIPELINE_ONLY = {"pipeline_wait_ms"}
CELLS = {"tiny-train-pipeline": ("tiny-train", "tiny-corpus"),
         "tiny-train-device": ("tiny-train", "tiny-device"),
         "tiny-generate": ("tiny-generate", "tiny-requests")}


def make_root(tmp: Path) -> Path:
    """A checkout-like root under ``tmp``: ``perfbench/`` copied, the tiny
    files added, the tiny cells in ``BENCHMARK.json`` beside the real
    metrics."""
    root = tmp / "root"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, opt in (("tiny-train", TRAIN), ("tiny-generate", GENERATE)):
        (root / "perfbench" / "configs" / f"{name}.json").write_text(json.dumps(
            {"name": name, "source": "test", "reduced": [], "options": opt}))
    for name, mix in MIXES.items():
        (root / "perfbench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": n, "source": "test", "file": f"perfbench/configs/{n}.json",
                         "reduced": [], "why": "test"} for n in ("tiny-train", "tiny-generate")]
    bench["workloads"] = [{"name": c, "config": cfg, "traffic": mix, "chips": 1, "why": "test"}
                          for c, (cfg, mix) in CELLS.items()]
    train = [c for c in CELLS if "train" in c]
    gen = [c for c in CELLS if "generate" in c]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            real = m["workloads"]
            m["workloads"] = ([c for c in CELLS if c.endswith("pipeline")]
                              if m["name"] in PIPELINE_ONLY
                              else train if any("train" in w for w in real) else gen)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root: Path, cell: str, seed: int = 7, seconds: float = 0.5, trace: int = 0,
        device: str = "cpu"):
    """A run of ``cell`` on ``device``, the look for a card skipped: (exit
    code, the parsed last line or None)."""
    import contextlib
    import io
    import time

    import torch

    from perfbench import harness

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                          "--trace", str(trace)], time.perf_counter(), root,
                         device=torch.device(device))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)


def copy_mix(name: str) -> dict:
    return copy.deepcopy(MIXES[name])
