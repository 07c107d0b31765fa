"""Where the flagship train step's device time goes on one GPU.

    python3 probes/train_profile.py [--batch 20] [--steps 3] [--no-cudnn] [--fp16] [--nchw]

The flagship G and D (reference initialisation, seed 0) and the flagship
Adam, on synthetic speech at 48 kHz with LR made by ``degrade_lr``, as
``chip_smoke.py`` trains them; with ``--no-cudnn``, with cuDNN disabled
for the whole process (PyTorch's own convolutions); with ``--fp16``, in
bf16, as ``train.sh``; with ``--nchw``, with the bf16 activations left
NCHW (``models/layers.py`` ``conv_nhwc`` answering no), the layout before
channels-last.  One JSON line each:

  * the generator's forward alone at the batch, by CUDA events (median of 5
    after 2 warm-ups): in train mode recording the graph, as the step runs
    it; in train mode without the graph; in eval mode without the graph;
  * the step's time by CUDA events, median of 5 after 2 warm-ups, the
    peak memory, and the memory the allocator still holds beyond live
    tensors once its cache is emptied: on the card the step's CUDA graphs'
    pool;
  * ``--steps`` train steps under ``torch.profiler``: the wall time per
    step, the card's busy time per step (the union of the kernel records),
    the kernel records per step, and the 12 kernels with the largest summed
    time per step, with their launches per step.  The sums overlap where
    kernels run concurrently, so they rank and do not apportion.  Beside
    them, cuDNN's layout transposes (``nchwToNhwc``/``nhwcToNchw``), the
    kernels named as copies and those named TF32, in ms per step;
  * the layout of one eager step, forward and backward: the counters
    ``conv.bf16_calls`` and ``conv.nhwc_in`` it adds, and every op that
    takes a channels-last input to an NCHW output or the reverse (views
    aside), counted by op and by the module it ran in (the innermost
    module's name in the forward; the autograd node in the backward), with
    the bytes it wrote.  The weights' casts (``_to_copy`` in a ``Conv``,
    ``_ChannelsLastWeightBackward``) and the networks' entries are by design.
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
    ap.add_argument("--fp16", action="store_true")
    ap.add_argument("--nchw", action="store_true")
    args = ap.parse_args(argv)
    torch.backends.cudnn.enabled = not args.no_cudnn
    if args.nchw:
        from mdctgan_tpu_torch.models import layers

        layers.conv_nhwc = lambda dtype, device: False
    dev = resolve_device("cuda")
    opt = dict(flagship_opt(), fp16=args.fp16)
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

    def make_step():
        return build_train_step(
            transform, g_tx, d_tx, use_lsgan=not tro["no_lsgan"],
            lambda_feat=tro["lambda_feat"], n_layers_d=tro["n_layers_D"], num_d=tro["num_D"],
            use_ganfeat=not tro["no_ganFeat_loss"])

    step = make_step()
    head = {"card": torch.cuda.get_device_name(0), "batch": b, "cudnn": not args.no_cudnn,
            "fp16": args.fp16, "nchw": args.nchw}

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
    torch.cuda.empty_cache()
    print(json.dumps({**head, "step_ms": statistics.median(times),
                      "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                      "held_beyond_allocated_bytes":
                          torch.cuda.memory_reserved() - torch.cuda.memory_allocated()}),
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

    def ms_of(pick):
        return sum(t for k, (t, _) in by_name.items() if pick(k)) / 1e3 / n

    copies = sorted(((k, t) for k, (t, _) in by_name.items() if "copy" in k.lower()),
                    key=lambda kv: -kv[1])
    print(json.dumps({
        **head, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_us / 1e3 / n, "records_per_step": len(records) / n,
        "transpose_ms_per_step": ms_of(lambda k: "nchwToNhwc" in k or "nhwcToNchw" in k),
        "copy_ms_per_step": ms_of(lambda k: "copy" in k.lower()),
        "copy_kernels_per_step": [{"name": k[:90], "ms": t / 1e3 / n} for k, t in copies[:6]],
        "tf32_kernels_per_step": [{"name": k[:90], "ms": t / 1e3 / n, "launches": c / n}
                                  for k, (t, c) in by_name.items() if "tf32" in k.lower()],
        "top_kernels_per_step": [{"name": k[:90], "ms": t / 1e3 / n, "launches": c / n}
                                 for k, (t, c) in top]}), flush=True)
    print(json.dumps({**head, "layout": layout_census(state, lambda: make_step()(state, batch))}),
          flush=True)
    return 0


def layout_census(state, run) -> dict:
    """The counters one eager step adds and the ops in it that change the
    layout (the module docstring).  ``run`` makes one eager step (a fresh
    train step's first call) under a dispatch mode that sees every op."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from mdctgan_tpu_torch.models.layers import channels_last as nhwc
    from mdctgan_tpu_torch.utils import tracing

    def nchw(t):
        return (t.dim() == 4 and t.is_contiguous()
                and not t.is_contiguous(memory_format=torch.channels_last))

    stack, found = [], collections.Counter()
    written = collections.Counter()

    class Census(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
            outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
            if {o.untyped_storage().data_ptr() for o in outs} & \
                    {a.untyped_storage().data_ptr() for a in ins}:
                return out  # a view or an in-place op moves nothing
            way = None
            if any(map(nhwc, ins)) and any(map(nchw, outs)):
                way = "nhwc->nchw"
            elif any(map(nchw, ins)) and any(map(nhwc, outs)):
                way = "nchw->nhwc"
            if way is not None:
                node = torch._C._current_autograd_node()
                where = (f"backward:{node.name()}" if node is not None
                         else (stack[-1] if stack else "-"))
                key = f"{way} {func.__name__} @ {where}"
                found[key] += 1
                written[key] += sum(o.numel() * o.element_size() for o in outs)
            return out

    def push(name):
        return lambda module, args: stack.append(name)

    def pop(module, args, out):
        stack.pop()

    hooks = []
    for module in (state.generator, state.discriminator):
        for name, m in module.named_modules():
            hooks.append(m.register_forward_pre_hook(push(type(m).__name__ + ":" + name)))
            hooks.append(m.register_forward_hook(pop))
    before = tracing.snapshot()
    try:
        with Census():
            run()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    after = tracing.snapshot()
    return {"counters": {k: after.get(k, 0) - before.get(k, 0)
                         for k in ("conv.bf16_calls", "conv.nhwc_in")},
            "layout_changes": [{"op": k, "calls": c, "mb": written[k] / 2 ** 20}
                               for k, c in found.most_common()]}


if __name__ == "__main__":
    raise SystemExit(main())
