"""Data parallelism's costs and controls on one GPU, at the flagship width.

    python3 probes/dp_probe.py [--parts step,tail,threads] [--out FILE]

Three parts, each printing JSON lines (and appending them to ``--out``):

  * ``step``: the bf16 train step at batch 20 without a process group and
    as the one rank of a world-1 NCCL group, in turns on the card (12
    rounds, the first two warm-ups): each step's time by CUDA events, the
    host's time to enqueue it (the call's return, before any wait), and the
    host's time between the step's marks (the spectra, G's forward, D's
    forward and the losses, the backward with the gradients' all-reduce,
    the optimizers, the metrics); then 3 steps of each under
    ``torch.profiler``: the host operators whose self CPU time a step grows
    most under the group, and the card's busy time a step.
  * ``tail``: the train CLI (``train.sh``'s flags, 1 epoch of 2 steps on a
    22-file corpus, so the second step is a masked tail of 2 rows, one
    decode thread) twice on one card and once as a world-1 ``--multihost``
    rank, in float32 and in bf16: each step's losses, and the second step's
    largest relative distance of each run from the first single-card run.
  * ``threads``: the train CLI at ``train.sh``'s ``--nThreads 16`` (3 epochs
    of 2 steps on a 40-file corpus) on one card, and as a world-1
    ``--multihost`` rank at 16 decode threads and at one: each step's time
    and its time blocked on the input pipeline (``next_ms``).

Run it from the repository root on a machine with one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BATCH = 20
ROUNDS = 12
WARMUP = 2
PROFILED = 3
MARKS = ("k1", "g_forward", "d_forward", "backward", "optimizer")


def emit(record: dict, out) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def one_rank_env() -> None:
    from mdctgan_tpu_torch.parallel import mesh
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(mesh.free_port()))


def step_part(out) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mdctgan_tpu_torch.configs import flagship_opt
    from mdctgan_tpu_torch.device import float32_policy
    from mdctgan_tpu_torch.models.discriminator import build_discriminator
    from mdctgan_tpu_torch.models.generator import build_generator
    from mdctgan_tpu_torch.ops.features import SpectralTransform
    from mdctgan_tpu_torch.options import spectral_config_from_opt, train_options
    from mdctgan_tpu_torch.parallel import mesh
    from mdctgan_tpu_torch.train import grad_truth as GT
    from mdctgan_tpu_torch.train.schedule import make_optimizers
    from mdctgan_tpu_torch.train.state import create_train_state
    from mdctgan_tpu_torch.train.step import build_train_step
    from mdctgan_tpu_torch.utils.profiling import busy_time_ms

    dev = torch.device("cuda")
    opt = dict(flagship_opt(), fp16=True)
    cfg = spectral_config_from_opt(opt)
    tro = train_options(opt)
    g_tx, d_tx = make_optimizers(tro["lr"], tro["beta1"], tro["niter"], tro["niter_decay"], 1000)
    noise = GT.inputs("noise", np.random.default_rng(0), BATCH, cfg.segment_length)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in noise.items()}
    one_rank_env()
    ranks = mesh.init_multihost("cuda")
    try:
        with float32_policy():
            runs = {}
            for kind, r in (("plain", None), ("world1", ranks)):
                state = create_train_state(
                    build_generator(opt), build_discriminator(opt), g_tx, d_tx, device=dev,
                    rng=torch.Generator().manual_seed(0), ranks=r)
                step = build_train_step(SpectralTransform(cfg, dev), g_tx, d_tx,
                                        n_layers_d=tro["n_layers_D"], num_d=tro["num_D"],
                                        ranks=r)
                runs[kind] = {"state": state, "step": step, "ms": [], "enqueue_ms": [],
                              "host_marks": []}

            def timed(kind):
                run = runs[kind]
                stamps = []
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                run["step"](run["state"], batch,
                            mark=lambda name: stamps.append((name, time.perf_counter())))
                t1 = time.perf_counter()
                end.record()
                end.synchronize()
                run["ms"].append(start.elapsed_time(end))
                run["enqueue_ms"].append((t1 - t0) * 1e3)
                prev, marks = t0, {}
                for name, t in stamps:
                    marks[name] = (t - prev) * 1e3
                    prev = t
                marks["metrics"] = (t1 - prev) * 1e3
                run["host_marks"].append(marks)

            for i in range(ROUNDS):
                for kind in (("plain", "world1") if i % 2 else ("world1", "plain")):
                    timed(kind)
            summary = {}
            for kind, run in runs.items():
                kept = run["host_marks"][WARMUP:]
                summary[kind] = {
                    "step_ms_median": statistics.median(run["ms"][WARMUP:]),
                    "enqueue_ms_median": statistics.median(run["enqueue_ms"][WARMUP:]),
                    "step_ms_all": run["ms"], "enqueue_ms_all": run["enqueue_ms"],
                    "host_ms_by_mark_median": {
                        name: statistics.median(m[name] for m in kept)
                        for name in (*MARKS, "metrics")}}
            emit({"part": "step", "precision": "bf16", "batch": BATCH,
                  "env_TORCH_NCCL_AVOID_RECORD_STREAMS":
                      os.environ.get("TORCH_NCCL_AVOID_RECORD_STREAMS"),
                  "runs": summary,
                  "overhead_ms": summary["world1"]["step_ms_median"]
                  - summary["plain"]["step_ms_median"]}, out)

            ops = {}
            for kind, run in runs.items():
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(PROFILED):
                        run["step"](run["state"], batch)
                    torch.cuda.synchronize()
                per = {}
                for e in prof.key_averages():
                    if e.device_type == DeviceType.CPU:
                        per[e.key] = (e.self_cpu_time_total / 1e3 / PROFILED,
                                      e.count / PROFILED)
                ops[kind] = per
                emit({"part": "step_profile", "kind": kind,
                      "busy_ms_per_step": busy_time_ms(prof, PROFILED),
                      "host_self_ms_per_step": sum(v[0] for v in per.values())}, out)
            names = set(ops["plain"]) | set(ops["world1"])
            grown = sorted(((ops["world1"].get(n, (0.0, 0.0))[0]
                             - ops["plain"].get(n, (0.0, 0.0))[0], n) for n in names),
                           reverse=True)[:25]
            emit({"part": "step_profile_growth", "top": [
                {"op": n, "world1_self_ms": ops["world1"].get(n, (0.0, 0.0))[0],
                 "plain_self_ms": ops["plain"].get(n, (0.0, 0.0))[0],
                 "world1_calls": ops["world1"].get(n, (0.0, 0.0))[1],
                 "plain_calls": ops["plain"].get(n, (0.0, 0.0))[1]} for _, n in grown]}, out)
    finally:
        torch.distributed.destroy_process_group()


def _corpus(root: Path, n_files: int) -> list:
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_corpus.py"), str(root),
                    "--style", "speech", "--n_files", str(n_files), "--seconds", "2.0",
                    "--seed", "7"], check=True, timeout=300)
    return ["--dataroot", str(root / "train.csv"), "--evalroot", str(root / "eval.csv")]


def _cli(flags, tmp: Path, tag: str, multihost: bool) -> dict:
    from mdctgan_tpu_torch import train_cli
    if multihost:
        one_rank_env()
    run = train_cli.main(flags + (["--multihost"] if multihost else []) + [
        "--gpu_ids", "0", "--checkpoints_dir", str(tmp / tag), "--name", "run"])
    run.pop("state", None)
    return run


def tail_part(out) -> None:
    import chip_smoke as cs

    with tempfile.TemporaryDirectory(prefix="dp_probe_", dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        data = _corpus(tmp / "corpus", 24)  # 22 train files: 20 + a tail of 2
        for precision in ("f32", "bf16"):
            flags = cs.DP_CLI_FLAGS + data
            if precision == "f32":
                flags = [f for f in flags if f != "--fp16"]
            losses = {}
            for kind, multihost in (("single", False), ("single_again", False),
                                    ("multihost", True)):
                run = _cli(flags, tmp, f"{precision}_{kind}", multihost)
                losses[kind] = [{k: v for k, v in row.items() if k not in ("step", "epoch")}
                                for row in run["losses"]]

            def rel(a, b, i):
                return max(abs(a[i][k] - v) / max(abs(v), 1e-30) for k, v in b[i].items())

            emit({"part": "tail", "precision": precision, "tail_rows": 2, "losses": losses,
                  "step1_multihost_vs_single": rel(losses["multihost"], losses["single"], 0),
                  "step2_multihost_vs_single": rel(losses["multihost"], losses["single"], 1),
                  "step2_single_again_vs_single": rel(losses["single_again"],
                                                      losses["single"], 1)}, out)


def threads_part(out) -> None:
    import chip_smoke as cs

    with tempfile.TemporaryDirectory(prefix="dp_probe_", dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        data = _corpus(tmp / "corpus", 40)  # 36 train files: 2 steps an epoch
        base = cs.DP_CLI_FLAGS + data + ["--niter", "3"]
        for tag, threads, multihost in (("single_16", "16", False),
                                        ("multihost_16", "16", True),
                                        ("multihost_1", "1", True)):
            run = _cli(base + ["--nThreads", threads], tmp, tag, multihost)
            steps = run["steps"]
            emit({"part": "threads", "run": tag, "nThreads": int(threads),
                  "multihost": multihost, "setup_ms": run["setup_ms"],
                  "step_ms": [s["ms"] for s in steps],
                  "next_ms": [s["next_ms"] for s in steps],
                  "next_ms_median_after_first": statistics.median(
                      s["next_ms"] for s in steps[1:])}, out)


def main(argv=None) -> int:
    from mdctgan_tpu_torch.ops import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default="step,tail,threads")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit({"card": smi.strip(), "torch": torch.__version__}, args.out)
    (ROOT / "build").mkdir(exist_ok=True)
    _build.build()
    parts = {"step": step_part, "tail": tail_part, "threads": threads_part}
    for name in args.parts.split(","):
        parts[name](args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
