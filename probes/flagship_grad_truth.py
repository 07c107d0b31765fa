"""Which block of the port carries its float32 gradient error at flagship width.

    python3 probes/flagship_grad_truth.py [--data noise|speech] [--batch 8] [--seed 0]
                                          [--variants [f32 norms_f64 ...]] [--smooth BETA]

One SGD(lr=1) step (its update is the gradient) of the flagship G and D
from the seeded random weights of ``weights.random_jax_trees``, as
``chip_smoke.py`` draws them, in float64 on the CPU (the truth) and in
float32 variants on the CPU and, where there is a card, on it.  A variant
changes one block of the float32 run:

  f32            the port as it is
  norms_f64      every instance norm and BatchNorm computed in float64
  in_f64         only the instance norms in float64
  bn_f64         only the attention stack's BatchNorms in float64
  attn_f64       the whole attention stack (``BottleStack``) in float64
  attn_core_f64  only the attention itself (``Attention2D``) in float64
  norms_stock    instance norm and BatchNorm through ``F.instance_norm`` /
                 ``F.batch_norm``, the reference model's stock layers
  card_spectra   (CPU) the float32 step fed the card's spectra (K1's)
                 instead of the CPU's own (K1's plain version)
  cudnn_off      (card) PyTorch's own convolutions instead of cuDNN's
  tf32           (card) TF32 allowed

Three float64 truths: from the audio (the spectra in float64 too), and
from the float32 spectra of the CPU or of the card, upcast, as the JAX
package's probe (``tools/flagship_grad_truth.py``) feeds one set of float32
spectra to both of its torch runs; each truth is also held against the
others (``--variants`` with no names runs only the truths).  Against each
truth every run prints, per network, over the tensors whose true gradient
has norm >= 1e-6 (the JAX probe's "live" tensors): the median and largest
normwise error, the largest share of the JAX flagship bound (G 2.5e-2, D
5e-3, floor 1e-3) and the worst tensors.  Each card run is also held
against the CPU run of the same variant and against the CPU's
``card_spectra`` run: card against CPU on the same input spectra.  The JAX
probe measured torch's own float32 error at its init and data, batch 8:
G median 4.1e-3, max 4.7e-3; D max 1.4e-3.

For card runs held against the CPU on the same spectra, ``conditioning``
is the least C for which every live tensor k satisfies
||card - cpu||_k <= rel * ||cpu||_k + floor + C * ||T_card - T_cpu||_k,
where T_card and T_cpu are the float64 truths fed the card's and the CPU's
float32 spectra: how many times the float64 step's own movement under
float32 rounding of its input the card's difference from the CPU is.

``--smooth BETA`` replaces every kink of the step, in every run and truth,
by a smooth function of width 1/BETA: ReLU by softplus, leaky ReLU by
0.2 x + 0.8 softplus(x), |x| (the abs input channel and the L1 feature
matching) by sqrt(x^2 + BETA^-2).  Where the float32 error collapses then,
it was carried by activations that round to the other side of a kink.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from mdctgan_tpu_torch.configs import flagship_opt  # noqa: E402
from mdctgan_tpu_torch.models import attention, discriminator, layers  # noqa: E402
from mdctgan_tpu_torch.models.generator import build_generator  # noqa: E402
from mdctgan_tpu_torch.ops.features import SpectralTransform  # noqa: E402
from mdctgan_tpu_torch.options import spectral_config_from_opt  # noqa: E402
from mdctgan_tpu_torch.train import grad_truth as GT  # noqa: E402
from mdctgan_tpu_torch.weights import random_jax_trees, state_dict_from_jax  # noqa: E402

BLOCK_VARIANTS = ("f32", "norms_f64", "in_f64", "bn_f64", "attn_f64", "attn_core_f64",
                  "norms_stock")
CPU_VARIANTS = BLOCK_VARIANTS + ("card_spectra",)
CARD_VARIANTS = BLOCK_VARIANTS + ("cudnn_off", "tf32")
LIVE = 1e-6
_INSTANCE_NORM = layers.instance_norm


@contextlib.contextmanager
def _patched(obj, attr, value):
    saved = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, saved)


def _in_f64(modules):
    """Each module's parameters and buffers in float64, its first input cast
    up and its output cast back."""
    for m in modules:
        m.double()
        m.register_forward_pre_hook(lambda _, args: (args[0].double(),) + tuple(args[1:]))
        m.register_forward_hook(lambda _, args, out: out.float())


def _instance_norm_f64(x):
    return _INSTANCE_NORM(x.double()).to(x.dtype)


def _stock_instance_norm(x):
    return F.instance_norm(x, eps=1e-5)


def _stock_bn(self, x, mask=None):
    if mask is not None:
        raise ValueError("the stock BatchNorm cannot mask")
    return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                        self.training, self.momentum, self.eps)


@contextlib.contextmanager
def _smooth(beta):
    """Every ReLU, leaky ReLU and |x| of the step smooth, of width 1/beta."""
    relu, absolute = torch.relu, torch.abs

    def soft(x):
        return F.softplus(x, beta=beta)

    def leaky(x, slope=0.2):
        return slope * x + (1.0 - slope) * soft(x)

    def smooth_abs(x):
        return torch.sqrt(x * x + beta ** -2)

    torch.relu, torch.abs = soft, smooth_abs
    try:
        with _patched(discriminator, "leaky_relu", leaky):
            yield
    finally:
        torch.relu, torch.abs = relu, absolute


def variant(name, nets):
    """Apply ``name`` to ``nets``; the context manager holds the patches."""
    stack = contextlib.ExitStack()
    g = nets["G"]
    if name in ("norms_f64", "in_f64"):
        for mod in (layers, discriminator):
            stack.enter_context(_patched(mod, "instance_norm", _instance_norm_f64))
    if name in ("norms_f64", "bn_f64"):
        _in_f64([m for m in g.modules() if isinstance(m, attention._BN2d)])
    if name == "attn_f64":
        _in_f64([m for m in g.modules() if isinstance(m, attention.BottleStack)])
    if name == "attn_core_f64":
        _in_f64([m for m in g.modules() if isinstance(m, attention.Attention2D)])
    if name == "norms_stock":
        for mod in (layers, discriminator):
            stack.enter_context(_patched(mod, "instance_norm", _stock_instance_norm))
        stack.enter_context(_patched(attention._BN2d, "forward", _stock_bn))
    if name == "cudnn_off":
        stack.enter_context(torch.backends.cudnn.flags(enabled=False))
    return stack


def summary(truth, got, rel):
    live = [k for k, t in truth.items() if float(t.norm()) >= LIVE]
    errs = {k: float((got[k] - truth[k]).norm()) / float(truth[k].norm()) for k in live}
    nw = GT.normwise({k: truth[k] for k in live}, {k: got[k] for k in live}, rel, top=4)
    return {"live": len(live), "median": statistics.median(errs.values()),
            "max": max(errs.values()), "max_share_of_bound": nw["max_share"],
            "worst_share": [{"name": w["name"], "rel_err": w["rel_err"], "share": w["share"]}
                            for w in nw["worst"]],
            "worst_rel": [{"name": k, "rel_err": errs[k], "norm": float(truth[k].norm())}
                          for k in sorted(errs, key=errs.get, reverse=True)[:4]]}


def conditioning(cpu, card, t_card, t_cpu, rel):
    """The least C with ||card - cpu|| <= rel*||cpu|| + floor + C*||t_card -
    t_cpu|| on every live tensor, and the tensor that sets it."""
    worst, name = 0.0, None
    for k, t in t_cpu.items():
        if float(t.norm()) < LIVE:
            continue
        excess = float((card[k] - cpu[k]).norm()) - rel * float(cpu[k].norm()) - GT.FLOOR
        moved = float((t_card[k] - t).norm())
        if excess > 0 and excess > worst * moved:
            worst, name = (excess / moved if moved > 0 else float("inf")), k
    return {"factor": worst, "tensor": name}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", choices=("noise", "speech"), default="noise")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", nargs="*", default=None)
    ap.add_argument("--smooth", type=float, default=None)
    args = ap.parse_args(argv)
    with _smooth(args.smooth) if args.smooth else contextlib.nullcontext():
        return run(args)


def run(args) -> int:
    opt = flagship_opt()
    cfg = spectral_config_from_opt(opt)
    rng = np.random.default_rng(args.seed)
    g_sd = state_dict_from_jax(*random_jax_trees(build_generator(opt), rng))
    d_sd = state_dict_from_jax(*random_jax_trees(discriminator.build_discriminator(opt), rng))
    batch = GT.inputs(args.data, rng, args.batch, cfg.segment_length)
    cpu = torch.device("cpu")
    card = torch.cuda.is_available()
    head = {"data": args.data, "batch": args.batch, "seed": args.seed,
            "smooth": args.smooth, "cpu_threads": torch.get_num_threads()}
    if card:
        head["card"] = torch.cuda.get_device_name(0)

    t64 = SpectralTransform(cfg, cpu, torch.float64)
    truths_from = {"audio_f64": t64,
                   "cpu_f32_spectra": GT.SharedSpectra(t64, SpectralTransform(cfg, cpu))}
    if card:
        truths_from["card_f32_spectra"] = GT.SharedSpectra(t64, SpectralTransform(cfg, "cuda"))
    truths = {}
    for name, transform in truths_from.items():
        t0 = time.perf_counter()
        nets = GT.load_nets(opt, g_sd, d_sd, torch.float64)
        losses, truths[name] = GT.sgd_step(opt, nets, transform, batch, cpu)
        print(json.dumps({**head, "truth": name, "s": time.perf_counter() - t0,
                          "losses": losses}), flush=True)
    # how far the float64 step itself moves when only its input spectra
    # are rounded to float32: the conditioning no float32 run can beat
    names = list(truths)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            print(json.dumps({**head, "truth": b, f"vs_{a}": {
                net: summary(truths[a][net], truths[b][net], rel)
                for net, rel in GT.BOUNDS.items()}}), flush=True)

    runs = {}
    plan = [("cpu", v) for v in CPU_VARIANTS] + ([("card", v) for v in CARD_VARIANTS]
                                                 if card else [])
    if args.variants is not None:
        plan = [(d, v) for d, v in plan if v in args.variants]
    for where, name in plan:
        device = cpu if where == "cpu" else torch.device("cuda")
        nets = GT.load_nets(opt, g_sd, d_sd)
        transform = SpectralTransform(cfg, device)
        if name == "card_spectra":
            if not card:
                continue
            transform = GT.SharedSpectra(transform, SpectralTransform(cfg, "cuda"))
        t0 = time.perf_counter()
        with variant(name, nets):
            losses, grads = GT.sgd_step(opt, nets, transform, batch,
                                        device, allow_tf32=name == "tf32")
        runs[where, name] = grads
        out = {**head, "run": f"{where}_{name}", "s": time.perf_counter() - t0,
               "losses": losses}
        for tname, truth in truths.items():
            out[f"vs_{tname}"] = {net: summary(truth[net], grads[net], rel)
                                  for net, rel in GT.BOUNDS.items()}
        for key, label in ((("cpu", name), "vs_cpu_same_variant"),
                           (("cpu", "card_spectra"), "vs_cpu_card_spectra")):
            if where == "card" and key in runs:
                out[label] = {net: summary(runs[key][net], grads[net], rel)
                              for net, rel in GT.BOUNDS.items()}
        if (where == "card" and ("cpu", "card_spectra") in runs
                and {"card_f32_spectra", "cpu_f32_spectra"} <= set(truths)):
            for net, rel in GT.BOUNDS.items():
                out["vs_cpu_card_spectra"][net]["conditioning"] = conditioning(
                    runs["cpu", "card_spectra"][net], grads[net],
                    truths["card_f32_spectra"][net], truths["cpu_f32_spectra"][net], rel)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
