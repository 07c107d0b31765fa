"""The compile check and the data-parallel dry run: the port of
``__graft_entry__.py``'s two functions.

``entry(device="cuda")`` -> ``(fn, example_args)``: the flagship serving
chain (``train/step.py`` ``InferenceModule``: K1, the LocalEnhancer, K2)
at seeded weights, and one zero segment of ``segment_length`` on
``device``; ``fn(lr_audio)`` is the SR waveform, under the float32 policy.
It is the single-device check that the whole chain builds and runs.

``dryrun_multichip(n, device="cuda")`` -> the losses of one train step of
the tiny configuration (``configs.tiny_opt``, the JAX package's) over n
ranks, one sample a rank, through ``parallel.mesh.spawn``: NCCL on n cards,
gloo on the CPU; and each rank's kernel launches.  The batch is
``train/grad_truth.py``'s noise input, the steps its ``sgd_step``.  It holds the ranks to one process on the same global
batch, as the JAX function holds an n-device mesh to one device: the Adam
step's losses within 1e-4 (relative, floor 1), and an SGD(lr=1) step's
update (the all-reduced gradient) within 2e-4 of the tree's largest
movement.  With fewer cards than n it raises, where JAX clamps to the
devices it has, as the port's ``--gpu_ids`` does; ``backend="gloo"`` puts
the ranks on the cards in turn, so that several share one.

    python -m mdctgan_tpu_torch.dryrun [multichip N] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mdctgan_tpu_torch import api
from mdctgan_tpu_torch.configs import flagship_opt, tiny_opt
from mdctgan_tpu_torch.device import float32_policy, resolve_device
from mdctgan_tpu_torch.models.discriminator import build_discriminator
from mdctgan_tpu_torch.models.generator import build_generator
from mdctgan_tpu_torch.ops import mdct_kernels as K
from mdctgan_tpu_torch.ops.features import SpectralTransform
from mdctgan_tpu_torch.options import spectral_config_from_opt
from mdctgan_tpu_torch.parallel import mesh
from mdctgan_tpu_torch.train import grad_truth as GT
from mdctgan_tpu_torch.train.schedule import OptimizerSpec
from mdctgan_tpu_torch.train.state import create_train_state
from mdctgan_tpu_torch.train.step import InferenceModule

LOSS_REL = 1e-4  # the JAX dry run's bound on the losses
UPDATE_REL = 2e-4  # and on the SGD(1) update, of the tree's largest movement
SEED = 0
DEADLINE_S = 600.0  # the ranks' whole run, spawn included

_ADAM = OptimizerSpec(functools.partial(torch.optim.Adam, lr=2e-4, betas=(0.5, 0.999),
                                        eps=1e-8))
_SGD = OptimizerSpec(functools.partial(torch.optim.SGD, lr=1.0))


def entry(device="cuda"):
    """``(fn, (lr_audio,))``: the flagship's serving chain at the reference
    initialisation (``api.create_model``'s, seeded) and a zero segment."""
    opt = flagship_opt()
    model = api.create_model(opt, device)
    module = InferenceModule(model.generator, model.transform,
                             out_length=model.transform.cfg.segment_length)

    def fn(lr_audio: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), float32_policy():
            return module(lr_audio)[1]

    return fn, (torch.zeros((1, opt["segment_length"]), device=model.device),)


def tiny_state_dicts() -> Tuple[Dict, Dict]:
    """G's and D's state dicts of the tiny configuration at the reference
    initialisation drawn from ``SEED``."""
    opt = tiny_opt()
    gen, disc = build_generator(opt), build_discriminator(opt)
    create_train_state(gen, disc, _SGD, _SGD, device="cpu",
                       rng=torch.Generator().manual_seed(SEED))
    return gen.state_dict(), disc.state_dict()


def tiny_step(tx: OptimizerSpec, g_sd, d_sd, batch, device,
              ranks: Optional[mesh.Ranks] = None) -> Tuple[Dict[str, float], Dict]:
    """``grad_truth.sgd_step`` of the tiny configuration from ``g_sd``/``d_sd``
    with ``tx`` for both nets, on this rank's rows of ``batch`` (all of
    them without ranks) -> (the losses, G's update as float64 numpy by
    name, which a rank's result pickles without shared memory)."""
    opt = tiny_opt()
    rows = slice(None) if ranks is None else ranks.host_rows(len(batch["hr_audio"]))
    metrics, updates = GT.sgd_step(
        opt, GT.load_nets(opt, g_sd, d_sd), SpectralTransform(spectral_config_from_opt(opt),
                                                              device),
        {k: v[rows] for k, v in batch.items()}, device, ranks=ranks, tx=tx)
    return metrics, {k: v.numpy() for k, v in updates["G"].items()}


def _rank(ranks: mesh.Ranks, g_sd, d_sd, batch) -> Dict:
    """What each rank of ``dryrun_multichip`` runs: the Adam step's losses
    and G's SGD(1) update, both from the same weights, and the kernel
    launches of the two."""
    K.reset_launch_counts()
    metrics, _ = tiny_step(_ADAM, g_sd, d_sd, batch, ranks.device, ranks)
    _, g_sgd = tiny_step(_SGD, g_sd, d_sd, batch, ranks.device, ranks)
    return {"metrics": metrics, "generator": g_sgd, "launches": dict(K.LAUNCHES)}


def rank_devices(n_devices: int, device="cuda", backend: Optional[str] = None) -> List[str]:
    """One device a rank: the CPU for each, or the cards ``cuda:0`` ..
    ``cuda:n-1``; raises with fewer cards, unless ``backend`` is gloo,
    which puts the ranks on the cards in turn."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ["cpu"] * n_devices
    count = torch.cuda.device_count()
    if backend == "gloo":
        return [f"cuda:{i % count}" for i in range(n_devices)]
    if n_devices > count:
        raise ValueError(f"dryrun_multichip({n_devices}): this host has {count} CUDA "
                         "device(s), and NCCL takes one a rank")
    return [f"cuda:{i}" for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device="cuda", backend: Optional[str] = None
                     ) -> Tuple[Dict[str, float], List[Dict[str, int]]]:
    """One step of the tiny configuration over ``n_devices`` ranks, held to
    one process on the same global batch (module docstring); returns the
    ranks' losses and each rank's kernel launches (``K.LAUNCHES``, K1 twice
    a step on a card, none on the CPU)."""
    devices = rank_devices(n_devices, device, backend)
    g_sd, d_sd = tiny_state_dicts()
    # one sample a rank
    batch = GT.inputs("noise", np.random.default_rng(SEED), n_devices,
                      tiny_opt()["segment_length"])
    results = mesh.spawn(_rank, devices, args=(g_sd, d_sd, batch), backend=backend,
                         deadline_s=DEADLINE_S)
    metrics, g_after = results[0]["metrics"], results[0]["generator"]
    one, _ = tiny_step(_ADAM, g_sd, d_sd, batch, devices[0])
    for k in ("loss_G", "loss_D"):
        a, c = metrics[k], one[k]
        if not abs(a - c) <= LOSS_REL * max(abs(c), 1.0):
            raise AssertionError(f"DP mismatch on {k}: {n_devices} ranks {a} vs 1 rank {c}")
    _, g_one = tiny_step(_SGD, g_sd, d_sd, batch, devices[0])
    # the tree-wide gradient scale, as in JAX: reduction noise in one leaf
    # couples to the whole tree through shared upstream activations
    scale = max(1.0, max(float(np.abs(v).max()) for v in g_one.values()))
    for k, v in g_one.items():
        err = float(np.abs(g_after[k] - v).max())
        if not err <= UPDATE_REL * scale:
            raise AssertionError(f"DP gradient mismatch at {k}: max|diff|={err:.3e} "
                                 f"vs tree scale {scale:.3e}")
    print(f"dryrun_multichip OK on {n_devices} ranks (+ DP invariance vs 1 rank):", metrics)
    return metrics, [r["launches"] for r in results]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", nargs="?", choices=["multichip"])
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.what == "multichip":
        dryrun_multichip(args.n, args.device)
        return
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry OK:", tuple(out.shape), out.dtype)


if __name__ == "__main__":
    main()
