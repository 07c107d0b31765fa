"""Where the flagship train step's device time goes on one GPU.

    python3 probes/train_profile.py [--batch 20] [--steps 3] [--no-cudnn]

The flagship G and D (reference initialisation, seed 0) and the flagship
Adam, on synthetic speech at 48 kHz with LR made by ``degrade_lr``, as
``chip_smoke.py`` trains them; with ``--no-cudnn``, with cuDNN disabled
for the whole process (PyTorch's own convolutions).  One JSON line each:

  * the generator's forward alone at the batch, by CUDA events (median of 5
    after 2 warm-ups): in train mode recording the graph, as the step runs
    it; in train mode without the graph; in eval mode without the graph;
  * the step's time by CUDA events, median of 5 after 2 warm-ups, and the
    peak memory;
  * ``--steps`` train steps under ``torch.profiler``: the wall time per
    step, the card's busy time per step (the union of the kernel records),
    the kernel records per step, and the 12 kernels with the largest summed
    time per step, with their launches per step.  The sums overlap where
    kernels run concurrently, so they rank and do not apportion.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mdctgan_tpu_torch.configs import flagship_opt
    from mdctgan_tpu_torch.data.synthetic import speech_like
    from mdctgan_tpu_torch.device import float32_policy, resolve_device
    from mdctgan_tpu_torch.models.discriminator import build_discriminator
    from mdctgan_tpu_torch.models.generator import build_generator
    from mdctgan_tpu_torch.ops.features import SpectralTransform
    from mdctgan_tpu_torch.ops.resample import degrade_lr
    from mdctgan_tpu_torch.options import spectral_config_from_opt, train_options
    from mdctgan_tpu_torch.train.schedule import make_optimizers
    from mdctgan_tpu_torch.train.state import create_train_state
    from mdctgan_tpu_torch.train.step import build_train_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=20)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--no-cudnn", action="store_true")
    args = ap.parse_args(argv)
    torch.backends.cudnn.enabled = not args.no_cudnn
    dev = resolve_device("cuda")
    opt = flagship_opt()
    tro = train_options(opt)
    cfg = spectral_config_from_opt(opt)
    seg, b = cfg.segment_length, args.batch
    hr = speech_like(np.random.default_rng(0), b * seg / 48000, 48000)[: b * seg].reshape(b, seg)
    with torch.no_grad():
        lr = degrade_lr(torch.from_numpy(hr), 48000, cfg.lr_sampling_rate,
                        cfg.hr_sampling_rate)[:, :seg].contiguous()
    batch = {"lr_audio": lr.to(dev), "hr_audio": torch.from_numpy(hr).to(dev)}
    g_tx, d_tx = make_optimizers(tro["lr"], tro["beta1"], tro["niter"], tro["niter_decay"], 1000)
    state = create_train_state(build_generator(opt), build_discriminator(opt), g_tx, d_tx,
                               device=dev, rng=torch.Generator().manual_seed(0))
    transform = SpectralTransform(cfg, dev)
    step = build_train_step(
        transform, g_tx, d_tx, use_lsgan=not tro["no_lsgan"], lambda_feat=tro["lambda_feat"],
        n_layers_d=tro["n_layers_D"], num_d=tro["num_D"],
        use_ganfeat=not tro["no_ganFeat_loss"])
    head = {"card": torch.cuda.get_device_name(0), "batch": b, "cudnn": not args.no_cudnn}

    with torch.no_grad():
        g_in = transform.g_input(transform.lr_forward(batch["lr_audio"])[0])
    forward_ms = {}
    with float32_policy():
        for label, train, grad in (("train_graph", True, True), ("train_no_graph", True, False),
                                   ("eval_no_graph", False, False)):
            state.generator.train(train)
            runs = []
            for i in range(7):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                with torch.set_grad_enabled(grad):
                    start.record()
                    out = state.generator(g_in)
                    end.record()
                end.synchronize()
                del out
                if i >= 2:
                    runs.append(start.elapsed_time(end))
            forward_ms[label] = statistics.median(runs)
    print(json.dumps({**head, "generator_forward_ms": forward_ms}), flush=True)

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(7):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step(state, batch)
        end.record()
        end.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    print(json.dumps({**head, "step_ms": statistics.median(times),
                      "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}),
          flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    records = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us, reach = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in records):
        busy_us += max(0.0, hi - max(lo, reach))
        reach = max(reach, hi)
    by_name = {}
    for e in records:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    n = args.steps
    print(json.dumps({
        **head, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_us / 1e3 / n, "records_per_step": len(records) / n,
        "top_kernels_per_step": [{"name": k[:90], "ms": t / 1e3 / n, "launches": c / n}
                                 for k, (t, c) in top]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
