"""Per-convolution times of the flagship generator's forward on one GPU.

    python3 probes/conv_probe.py [--batches 16] [--backward]
    python3 probes/conv_probe.py --formats [--batches 8 20]

For each batch: the flagship ``LocalEnhancer`` (reference initialisation,
seed 0) in eval mode without a graph, on random input, under the port's
float32 policy.  CUDA events around every convolution call give each
convolution's time, median of 3 forwards after 2 warm-ups.

The default compares the ways a float32 convolution can run, each put in
place of ``models.layers.conv_forward`` for every convolution of G:
``heuristic`` (the whole batch, cuDNN's heuristic choice), ``cudnn_off``
(the whole batch with cuDNN disabled for the call: PyTorch's own im2col
and cuBLAS kernels), ``slices_8`` (slices of 8 rows through cuDNN, the
last one shorter), ``even_slices`` (the fewest slices of at most 8 rows,
of near-equal size) and ``port`` (``conv_forward`` as it stands).  One
JSON line a batch and way with the forward's time, the peak memory, the
sum over convolutions and, with ``--backward``, a forward and backward of
G's output sum; then one line a batch with each convolution's time by way
and the forward that takes the fastest way for each convolution.

``--formats`` is the earlier sweep: memory format (``contiguous``,
``channels_last``) by cuDNN algorithm choice (its heuristic; the
autotuner over ``benchmark_limit`` 10 candidates; the autotuner over
all), whole batches.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _whole(conv, x):
    if isinstance(conv, torch.nn.ConvTranspose2d):
        return F.conv_transpose2d(x, conv.weight, conv.bias, conv.stride, conv.padding,
                                  conv.output_padding, conv.groups, conv.dilation)
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding, conv.dilation,
                    conv.groups)


def _cudnn_off(conv, x):
    cudnn = torch.backends.cudnn
    saved = cudnn.enabled
    cudnn.enabled = False
    try:
        return _whole(conv, x)
    finally:
        cudnn.enabled = saved


def _slices_8(conv, x):
    return torch.cat([_whole(conv, p) for p in x.split(8)])


def _even_slices(conv, x):
    return torch.cat([_whole(conv, p) for p in x.tensor_split(math.ceil(x.shape[0] / 8))])


def _ways(port):
    return {"heuristic": _whole, "cudnn_off": _cudnn_off, "slices_8": _slices_8,
            "even_slices": _even_slices, "port": lambda conv, x: port(conv, x, None)}


def _patched(way, names, events):
    """A ``conv_forward`` that runs ``way`` and records CUDA events around
    each call by the convolution's name."""
    def conv_forward(conv, x, dtype):
        assert dtype is None, "the probe runs the float32 generator"
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        y = way(conv, x)
        b.record()
        events.setdefault(names[id(conv)], []).append((a, b, tuple(x.shape)))
        return y
    return conv_forward


def _time_forward(gen, x, events, runs: int = 3, backward: bool = False):
    totals, per_conv = [], {}
    for i in range(2 + runs):
        events.clear()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if backward:
            gen(x).sum().backward()
        else:
            with torch.no_grad():
                gen(x)
        end.record()
        end.synchronize()
        if i < 2:
            continue
        totals.append(start.elapsed_time(end))
        for name, calls in events.items():
            ms = sum(a.elapsed_time(b) for a, b, _ in calls)
            per_conv.setdefault(name, [calls[0][2], []])[1].append(ms)
    convs = {n: (shape, statistics.median(v)) for n, (shape, v) in per_conv.items()}
    return statistics.median(totals), convs


def _names(gen):
    return {id(m): n for n, m in gen.named_modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))}


def candidates(gen, dev, batches, backward: bool) -> None:
    from mdctgan_tpu_torch.models import attention, layers

    port = layers.conv_forward
    names = _names(gen)
    weights = {n: list(m.weight.shape) for n, m in gen.named_modules() if id(m) in names}
    card = torch.cuda.get_device_name(0)
    events = {}
    try:
        for b in batches:
            x = torch.randn(b, 2, 128, 256, generator=torch.Generator().manual_seed(b)).to(dev)
            by_way = {}
            for name, way in _ways(port).items():
                layers.conv_forward = attention.conv_forward = _patched(way, names, events)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                total, convs = _time_forward(gen, x, events)
                peak = torch.cuda.max_memory_allocated(dev)
                line = {"card": card, "batch": b, "way": name, "forward_ms": total,
                        "forward_ms_per_row": total / b, "memory_peak_gb": peak / 1e9,
                        "conv_ms": sum(ms for _, ms in convs.values())}
                if backward:
                    gen.requires_grad_(True)
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats(dev)
                    line["forward_backward_ms"] = _time_forward(gen, x, events, backward=True)[0]
                    line["forward_backward_memory_peak_gb"] = (
                        torch.cuda.max_memory_allocated(dev) / 1e9)
                    gen.requires_grad_(False)
                    gen.zero_grad(set_to_none=True)
                by_way[name] = convs
                print(json.dumps(line), flush=True)
            per_conv = {n: {"input": list(shape), "weight": weights[n],
                            **{w: by_way[w][n][1] for w in by_way}}
                        for n, (shape, _) in by_way["heuristic"].items()}
            best = {n: min((w for w in by_way if w != "port"), key=lambda w: row[w])
                    for n, row in per_conv.items()}
            print(json.dumps({"card": card, "batch": b, "per_conv_ms": per_conv,
                              "fastest_way": best,
                              "conv_ms_fastest_each": sum(per_conv[n][w] for n, w in best.items())}),
                  flush=True)
    finally:
        layers.conv_forward = attention.conv_forward = port


def formats(gen, dev, batches) -> None:
    from mdctgan_tpu_torch.models import attention, layers

    port = layers.conv_forward
    names = _names(gen)
    weights = {n: list(m.weight.shape) for n, m in gen.named_modules() if id(m) in names}
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.benchmark_limit
    events = {}
    layers.conv_forward = attention.conv_forward = _patched(_whole, names, events)
    try:
        for fmt in ("contiguous", "channels_last"):
            mf = torch.channels_last if fmt == "channels_last" else torch.contiguous_format
            gen = gen.to(memory_format=mf)
            for algo, bench, limit in (("heuristic", False, saved[1]),
                                       ("autotuner", True, 10), ("autotuner_all", True, 0)):
                cudnn.benchmark, cudnn.benchmark_limit = bench, limit
                for b in batches:
                    x = torch.randn(b, 2, 128, 256, generator=torch.Generator().manual_seed(b))
                    x = x.to(dev).contiguous(memory_format=mf)
                    total, convs = _time_forward(gen, x, events)
                    top = sorted(convs.items(), key=lambda kv: -kv[1][1])[:4]
                    print(json.dumps({
                        "card": torch.cuda.get_device_name(0), "batch": b,
                        "memory_format": fmt, "cudnn": algo, "forward_ms": total,
                        "conv_ms": sum(ms for _, ms in convs.values()),
                        "slowest": [{"conv": n, "input": list(shape), "weight": weights[n],
                                     "ms": ms} for n, (shape, ms) in top]}), flush=True)
    finally:
        cudnn.benchmark, cudnn.benchmark_limit = saved
        layers.conv_forward = attention.conv_forward = port


def main(argv=None) -> int:
    from mdctgan_tpu_torch.configs import flagship_opt
    from mdctgan_tpu_torch.device import float32_policy, resolve_device
    from mdctgan_tpu_torch.models.generator import build_generator
    from mdctgan_tpu_torch.weights import init_weights

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=None)
    ap.add_argument("--backward", action="store_true",
                    help="also time a forward and backward of each way")
    ap.add_argument("--formats", action="store_true",
                    help="the memory-format and algorithm sweep instead of the ways")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    gen = build_generator(flagship_opt())
    init_weights(gen, torch.Generator().manual_seed(0))
    gen = gen.to(dev).eval().requires_grad_(False)
    with float32_policy():
        if args.formats:
            formats(gen, dev, args.batches or [8, 20])
        else:
            candidates(gen, dev, args.batches or [16], args.backward)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
