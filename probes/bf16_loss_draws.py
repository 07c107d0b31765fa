"""Is the card's bf16 loss error biased?  Phase 8b of ``chip_smoke.py`` over
many seeded draws.

    python3 probes/bf16_loss_draws.py [--draws 20] [--seed 0] [--batch 2]
                                      [--out chiprun_out/bf16_loss_draws.jsonl]
                                      [--tiny] [--device cuda|cpu]

Each draw takes its own generator and discriminator weights
(``weights.random_jax_trees``) and its own white-noise batch
(``train/grad_truth.py`` ``inputs("noise")``) from ``--seed`` plus the
draw's index, at flagship width (``configs.flagship_opt``; ``--tiny`` the
tiny configuration, for a rehearsal on the CPU).  On it runs phase 8b's
comparison: one SGD(1) step (``grad_truth.sgd_step``) of bf16 G and D
(``--fp16``) on the card, the same on the CPU fed the card's spectra, and
the float64 step on the CPU fed the card's spectra, the truth.

Each draw prints one JSON line:

- ``loss``: each loss's signed relative error, (run - truth) / |truth|,
  for the card and for the CPU;
- ``d_logits``: per discriminator scale (the full-resolution scale first)
  and per half of D's two-batch call (``fake`` rows, ``real`` rows), the
  signed mean and the RMS of the card's and the CPU's logit-map error
  against the truth's, beside the truth's RMS;
- ``g_logits``: the same for G's output head before its tanh;
- ``check_8b``: phase 8b's loss check on this draw: the card's largest
  relative loss error against ``BF16_FACTOR`` (2) times the CPU's, and
  against that or one bf16 step (2^-8), whichever is larger.

The last line is the distribution over the draws: for each loss, the draws
on which the card's error is positive and negative, and the card's and the
CPU's median |error|.  A loss is biased on the card when one sign holds on
at least 80% of the draws and the card's median |error| is at least twice
the CPU's.  ``--device cpu`` runs the card's step on the CPU too (a
rehearsal: card and CPU then agree exactly).
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

from chip_smoke import BF16_FACTOR, BF16_STEP  # noqa: E402  (phase 8b's bounds)
from mdctgan_tpu_torch.configs import flagship_opt, tiny_opt  # noqa: E402
from mdctgan_tpu_torch.models.discriminator import build_discriminator  # noqa: E402
from mdctgan_tpu_torch.models.generator import build_generator  # noqa: E402
from mdctgan_tpu_torch.ops.features import SpectralTransform  # noqa: E402
from mdctgan_tpu_torch.options import spectral_config_from_opt  # noqa: E402
from mdctgan_tpu_torch.train import grad_truth as GT  # noqa: E402
from mdctgan_tpu_torch.weights import random_jax_trees, state_dict_from_jax  # noqa: E402

# a loss is biased when one sign holds on this share of the draws and the
# card's median |error| is this many times the CPU's
SIGN_SHARE = 0.8
MEDIAN_FACTOR = 2.0


def capture(nets):
    """Forward hooks that keep G's head output (before its tanh) and each
    D scale's logit map, as float64 CPU tensors; returns the store."""
    store = {"G": [], "D": {}}
    g = nets["G"]
    head = g.local_head if hasattr(g, "local_head") else g.head
    head.register_forward_hook(lambda _, args, out: store["G"].append(
        out.detach().cpu().double()))
    d = nets["D"]
    for i in range(d.num_D):  # the full-resolution scale first, as D returns them
        scale = getattr(d, f"scale{d.num_D - 1 - i}")
        last = getattr(scale, f"layer{scale.n_layers + 1}")
        store["D"][i] = []
        last.register_forward_hook(lambda _, args, out, i=i: store["D"][i].append(
            out.detach().cpu().double()))
    return store


def d_halves(store, batch: int):
    """Each scale's logit map of D's two-batch call (its last call in the
    step: fake rows, then real rows)."""
    out = {}
    for i, calls in store["D"].items():
        if calls[-1].shape[0] != 2 * batch:
            raise AssertionError(f"D's last call at scale {i} took {calls[-1].shape[0]} rows")
        out[i] = {"fake": calls[-1][:batch], "real": calls[-1][batch:]}
    return out


def moments(got: torch.Tensor, truth: torch.Tensor):
    err = got - truth
    return {"mean": float(err.mean()), "rms": float(err.square().mean().sqrt())}


def draw(index: int, args, opt, cfg, dev: torch.device) -> dict:
    rng = np.random.default_rng(args.seed + index)
    opt16 = dict(opt, fp16=True)
    g_sd = state_dict_from_jax(*random_jax_trees(build_generator(opt), rng))
    d_sd = state_dict_from_jax(*random_jax_trees(build_discriminator(opt), rng))
    batch = GT.inputs("noise", rng, args.batch, cfg.segment_length)
    cpu = torch.device("cpu")
    card_t = SpectralTransform(cfg, dev)
    cpu_t = SpectralTransform(cfg, cpu)
    f64_t = SpectralTransform(cfg, cpu, torch.float64)
    runs, stores, secs = {}, {}, {}
    for name, run_opt, dtype, device, transform in (
            ("truth", opt, torch.float64, cpu, GT.SharedSpectra(f64_t, card_t)),
            ("cpu", opt16, torch.float32, cpu, GT.SharedSpectra(cpu_t, card_t)),
            ("card", opt16, torch.float32, dev, card_t)):
        nets = GT.load_nets(run_opt, g_sd, d_sd, dtype)
        stores[name] = capture(nets)
        t0 = time.perf_counter()
        runs[name] = GT.sgd_step(run_opt, nets, transform, batch, device)[0]
        secs[name] = time.perf_counter() - t0
    truth = runs["truth"]
    loss = {side: {k: (runs[side][k] - v) / abs(v) for k, v in truth.items()}
            for side in ("card", "cpu")}
    d_truth = d_halves(stores["truth"], args.batch)
    d_logits = {}
    for i, halves in d_truth.items():
        d_logits[i] = {}
        for half, t in halves.items():
            d_logits[i][half] = {"truth_rms": float(t.square().mean().sqrt()),
                                 **{side: moments(d_halves(stores[side], args.batch)[i][half], t)
                                    for side in ("card", "cpu")}}
    g_t = stores["truth"]["G"][-1]
    g_logits = {"truth_rms": float(g_t.square().mean().sqrt()),
                **{side: moments(stores[side]["G"][-1], g_t) for side in ("card", "cpu")}}
    card_max = max(abs(v) for v in loss["card"].values())
    cpu_max = max(abs(v) for v in loss["cpu"].values())
    return {"draw": index, "seed": args.seed + index, "batch": args.batch, "loss": loss,
            "truth": truth, "d_logits": d_logits, "g_logits": g_logits,
            "check_8b": {"card_max_rel": card_max, "cpu_max_rel": cpu_max,
                         "ratio": card_max / cpu_max if cpu_max else None,
                         "within_factor": card_max <= BF16_FACTOR * cpu_max,
                         "within_bound": card_max <= max(BF16_FACTOR * cpu_max, BF16_STEP)},
            "step_s": secs}


def distribution(records) -> dict:
    out = {"draws": len(records)}
    for k in records[0]["loss"]["card"]:
        card = [r["loss"]["card"][k] for r in records]
        cpu = [r["loss"]["cpu"][k] for r in records]
        pos = sum(v > 0 for v in card)
        neg = sum(v < 0 for v in card)
        med_card = statistics.median(abs(v) for v in card)
        med_cpu = statistics.median(abs(v) for v in cpu)
        out[k] = {"card_positive": pos, "card_negative": neg,
                  "cpu_positive": sum(v > 0 for v in cpu),
                  "cpu_negative": sum(v < 0 for v in cpu),
                  "card_median_abs": med_card, "cpu_median_abs": med_cpu,
                  "card_mean": statistics.fmean(card), "cpu_mean": statistics.fmean(cpu),
                  "median_ratio": med_card / med_cpu if med_cpu else None,
                  "biased": (max(pos, neg) >= SIGN_SHARE * len(records)
                             and med_card >= MEDIAN_FACTOR * med_cpu)}
    scales = records[0]["d_logits"]
    out["d_logits_card_mean_positive"] = {
        f"{i}/{half}": sum(r["d_logits"][i][half]["card"]["mean"] > 0 for r in records)
        for i in scales for half in scales[i]}
    out["d_logits_rms_ratio_median"] = {
        f"{i}/{half}": statistics.median(r["d_logits"][i][half]["card"]["rms"]
                                         / r["d_logits"][i][half]["cpu"]["rms"]
                                         for r in records)
        for i in scales for half in scales[i]}
    out["g_logits_rms_ratio_median"] = statistics.median(
        r["g_logits"]["card"]["rms"] / r["g_logits"]["cpu"]["rms"] for r in records)
    out["check_8b"] = {
        "within_factor": sum(r["check_8b"]["within_factor"] for r in records),
        "within_bound": sum(r["check_8b"]["within_bound"] for r in records),
        "ratio_median": statistics.median(r["check_8b"]["ratio"] for r in records),
        "ratio_max": max(r["check_8b"]["ratio"] for r in records)}
    out["biased"] = sorted(k for k, v in out.items() if isinstance(v, dict) and v.get("biased"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    ap.add_argument("--tiny", action="store_true", help="the tiny configuration")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a rehearsal")
    opt = tiny_opt() if args.tiny else flagship_opt()
    cfg = spectral_config_from_opt(opt)
    out = open(args.out, "w") if args.out else None
    try:
        def emit(obj):
            line = json.dumps(obj)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()

        card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        emit({"device": card, "torch": torch.__version__, "cpu_threads": torch.get_num_threads(),
              "config": "tiny" if args.tiny else "flagship"})
        records = []
        for i in range(args.draws):
            records.append(draw(i, args, opt, cfg, dev))
            emit(records[-1])
        emit({"distribution": distribution(records)})
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
