"""Per-convolution times of the flagship generator's forward on one GPU.

    python3 probes/conv_probe.py [--batches 8 20]

For each batch: the flagship ``LocalEnhancer`` (reference initialisation,
seed 0) in eval mode without a graph, on random input, under the port's
float32 policy.  CUDA events around every ``Conv2d`` call (forward hooks)
give each convolution's time, median of 3 forwards after 2 warm-ups; one
JSON line per batch, memory format (``contiguous``, ``channels_last``)
and cuDNN algorithm choice (its heuristic, which the port uses; the
autotuner over ``benchmark_limit`` 10 candidates; the autotuner over all)
with the whole forward, the sum over convolutions and the slowest
convolutions with their shapes.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _probe(gen, x, runs: int = 3):
    events = {}

    def pre(name):
        def hook(module, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.setdefault(name, []).append([ev, None, tuple(args[0].shape)])
        return hook

    def post(name):
        def hook(module, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][-1][1] = ev
        return hook

    handles = []
    for name, m in gen.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            handles.append(m.register_forward_pre_hook(pre(name)))
            handles.append(m.register_forward_hook(post(name)))
    totals, per_conv = [], {}
    try:
        with torch.no_grad():
            for i in range(2 + runs):
                events.clear()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                gen(x)
                end.record()
                end.synchronize()
                if i < 2:
                    continue
                totals.append(start.elapsed_time(end))
                for name, calls in events.items():
                    ms = sum(a.elapsed_time(b) for a, b, _ in calls)
                    per_conv.setdefault(name, [calls[0][2], []])[1].append(ms)
    finally:
        for h in handles:
            h.remove()
    convs = {n: (shape, statistics.median(v)) for n, (shape, v) in per_conv.items()}
    return statistics.median(totals), convs


def main(argv=None) -> int:
    from mdctgan_tpu_torch.configs import flagship_opt
    from mdctgan_tpu_torch.device import float32_policy, resolve_device
    from mdctgan_tpu_torch.models.generator import build_generator
    from mdctgan_tpu_torch.weights import init_weights

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 20])
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    gen = build_generator(flagship_opt())
    init_weights(gen, torch.Generator().manual_seed(0))
    gen = gen.to(dev).eval()
    modules = {n: m for n, m in gen.named_modules()}
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.benchmark_limit
    try:
        with float32_policy():
            for fmt in ("contiguous", "channels_last"):
                mf = torch.channels_last if fmt == "channels_last" else torch.contiguous_format
                gen = gen.to(memory_format=mf)
                for algo, bench, limit in (("heuristic", False, saved[1]),
                                           ("autotuner", True, 10), ("autotuner_all", True, 0)):
                    cudnn.benchmark, cudnn.benchmark_limit = bench, limit
                    for b in args.batches:
                        x = torch.randn(b, 2, 128, 256, generator=torch.Generator().manual_seed(b))
                        x = x.to(dev).contiguous(memory_format=mf)
                        total, convs = _probe(gen, x)
                        top = sorted(convs.items(), key=lambda kv: -kv[1][1])[:4]
                        print(json.dumps({
                            "card": torch.cuda.get_device_name(0), "batch": b,
                            "memory_format": fmt, "cudnn": algo, "forward_ms": total,
                            "conv_ms": sum(ms for _, ms in convs.values()),
                            "slowest": [{"conv": n, "input": list(shape),
                                         "weight": list(modules[n].weight.shape), "ms": ms}
                                        for n, (shape, ms) in top]}), flush=True)
    finally:
        cudnn.benchmark, cudnn.benchmark_limit = saved
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
