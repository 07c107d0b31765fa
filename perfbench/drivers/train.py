"""The train cells' driver: ``train.sh``'s inner loop on the port.

Set-up builds one train state (G, D, their Adam optimizers) from weights
drawn on the card from ``--seed``, and drives it through its first steps
with the window's own feed and call: steps 1-3 are the checked ones (their
losses, the first gradient from Adam's first moment and G's BatchNorm
statistics after step 1, each leaf's change after step 3, the two kept on
the host), then ``warmup_steps`` more.  The window
hands the same state on and runs ``feed -> train_step`` for ``--seconds``;
with ``--trace 1`` it also records a CUDA event at each of the step's
marks, and a traced stretch follows it.  The check, after the
window, frees the port's state and has the plain reference follow the
first three steps from the same weights on the same raw rows, which it
degrades itself.

Feeds (the mix's ``feed``): ``pipeline``, the port's ``InputPipeline``
over a seeded corpus written at set-up (its native prefetcher crops at
random and the degrade runs on the card); ``device``, ``batches`` batches
degraded on the card at set-up and cycled.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench import checks, flops, readers, roofline
from perfbench.drivers.common import (
    Marks, Phases, annotate, free, memory_peak, reference_precision, sync, traced)
from perfbench.harness import Context, Record
from perfbench.reference import models as ref_models
from perfbench.reference.precision import FLOAT32, Precision
from perfbench.reference.train import bn_stats, follow
from perfbench.reference.transform import Transform, degrade
from perfbench.traffic import mix as traffic
from perfbench.weights import seeded_state_dicts

CHECKED_STEPS = 3


class DeviceFeed:
    """``batches`` batches degraded on the card at set-up, cycled."""

    def __init__(self, mix, seed, cfg, batch, device):
        from mdctgan_tpu_torch.data.pipeline import make_degrade_fn

        self.rate = mix["rate"]
        self.raw = traffic.segment_batches(mix, seed, batch, cfg.segment_length)
        degrade_fn = make_degrade_fn(cfg, self.rate, False, 55.0)
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            self.batches = [degrade_fn(torch.from_numpy(r).to(device), gen) for r in self.raw]
        self.i = 0
        self.taken: List[Tuple[np.ndarray, int]] = []
        self.recording = True

    def next(self) -> Dict[str, torch.Tensor]:
        j = self.i % len(self.batches)
        if self.recording:
            self.taken.append((self.raw[j], self.rate))
        self.i += 1
        return self.batches[j]

    def close(self) -> None:
        self.batches = []


class PipelineFeed:
    """The port's input pipeline over the mix's corpus; the raw crops of
    the recorded steps are kept for the reference."""

    def __init__(self, mix, seed, cfg, opt, device):
        from mdctgan_tpu_torch.data.dataset import AudioDataset
        from mdctgan_tpu_torch.data.pipeline import InputPipeline

        self.seed = seed
        index = traffic.write_corpus(mix, seed)
        ds = AudioDataset(index, cfg.segment_length, seed=seed)
        self.pipeline = InputPipeline(ds, cfg, opt["batchSize"], seed=seed,
                                      queue_size=mix["queue_size"], device=device,
                                      n_threads=opt["nThreads"])
        self.taken: List[Tuple[np.ndarray, int]] = []
        self.recording = True
        host = self.pipeline._next_host

        def tap():  # a copy of each recorded step's raw crops
            wave, rates = host()
            if self.recording:
                if len(set(rates.tolist())) != 1:
                    raise ValueError(f"corpus of mixed rates {sorted(set(rates.tolist()))}")
                self.taken.append((wave.numpy().copy(), int(rates[0])))
            return wave, rates

        self.pipeline._next_host = tap

    def next(self) -> Dict[str, torch.Tensor]:
        return next(self.pipeline)

    def close(self) -> None:
        self.pipeline.close()
        traffic.remove_corpus(self.seed)


def named_params(generator, discriminator):
    return ([(f"G.{k}", p) for k, p in generator.named_parameters()]
            + [(f"D.{k}", p) for k, p in discriminator.named_parameters()])


class TrainCell:
    def __init__(self, ctx: Context):
        self.ctx, self.dev = ctx, ctx.device
        self.opt = dict(ctx.cell.config["options"])
        self.mix = ctx.cell.traffic
        self.rec = Record("train")

    # ------------------------------------------------------------- set-up
    def setup(self) -> None:
        from mdctgan_tpu_torch.models.discriminator import build_discriminator
        from mdctgan_tpu_torch.models.generator import build_generator
        from mdctgan_tpu_torch.ops.features import SpectralTransform
        from mdctgan_tpu_torch.options import spectral_config_from_opt
        from mdctgan_tpu_torch.train.schedule import make_optimizers
        from mdctgan_tpu_torch.train.state import create_train_state
        from mdctgan_tpu_torch.train.step import build_train_step

        opt, dev, seed = self.opt, self.dev, self.ctx.seed
        phases = Phases(self.ctx.t0)
        self.cfg = cfg = spectral_config_from_opt(opt)
        batch = opt["batchSize"]
        phases.mark("start_and_imports")
        self.g_sd, self.d_sd = seeded_state_dicts(opt, dev, seed)
        sync(dev)
        phases.mark("weights")
        gen, disc = build_generator(opt).to(dev), build_discriminator(opt).to(dev)
        gen.load_state_dict(self.g_sd)
        disc.load_state_dict(self.d_sd)
        phases.mark("modules")
        g_tx, d_tx = make_optimizers(opt["lr"], opt["beta1"], opt["niter"],
                                     opt["niter_decay"], opt["steps_per_epoch"])
        self.state = create_train_state(gen, disc, g_tx, d_tx, device=dev)
        phases.mark("optimizers")
        self.step = build_train_step(
            SpectralTransform(cfg, dev), g_tx, d_tx, use_lsgan=not opt["no_lsgan"],
            lambda_feat=opt["lambda_feat"], n_layers_d=opt["n_layers_D"], num_d=opt["num_D"],
            use_ganfeat=not opt["no_ganFeat_loss"])
        phases.mark("transform")
        if self.mix["feed"] == "pipeline":
            self.feed = PipelineFeed(self.mix, seed, cfg, opt, dev)
        else:
            self.feed = DeviceFeed(self.mix, seed, cfg, batch, dev)
        phases.mark("feed")
        self.program = self.first_steps()
        phases.mark("checked_steps")
        self.feed.recording = False
        for _ in range(self.mix["warmup_steps"]):
            self.state, _ = self.step(self.state, self.feed.next())
        self.rec.shapes[readers.K1] = (batch, cfg.segment_length, cfg.n_fft)
        sync(dev)
        phases.mark("warmup_steps")
        self.rec.setup_s = time.perf_counter() - self.ctx.t0
        phases.report()

    def first_steps(self) -> Dict:
        """Steps 1-3 as the window runs them, and what the check reads of
        them."""
        beta1 = self.opt["beta1"]
        state = self.state
        named = named_params(state.generator, state.discriminator)
        start = {**{f"G.{k}": v for k, v in self.g_sd.items()},
                 **{f"D.{k}": v for k, v in self.d_sd.items()}}
        out: Dict = {"losses": []}
        for i in range(CHECKED_STEPS):
            state, metrics = self.step(state, self.feed.next())
            out["losses"].append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                moments = {**state.g_opt.state, **state.d_opt.state}
                out["grads"] = {
                    k: (moments[p]["exp_avg"] / (1.0 - beta1)).cpu() if p in moments
                    else torch.zeros(p.shape) for k, p in named}
                out["bn_stats"] = bn_stats(state.generator)
        with torch.no_grad():
            out["changes"] = {k: (p.detach() - start[k]).cpu() for k, p in named}
        checks.add_norms(out)
        self.state = state
        return out

    # ------------------------------------------------------------- window
    def window(self) -> None:
        from mdctgan_tpu_torch.ops import mdct_kernels

        ctx, rec, dev = self.ctx, self.rec, self.dev
        marks = Marks(dev) if ctx.trace else None
        waits, enqueues = [], []
        before = dict(mdct_kernels.LAUNCHES)
        state, step, feed = self.state, self.step, self.feed
        sync(dev)
        t0 = time.perf_counter()
        while True:
            ta = time.perf_counter()
            batch = feed.next()
            tb = time.perf_counter()
            if marks is not None:
                marks.begin()
            state, _ = step(state, batch, mark=None if marks is None else marks.mark)
            tc = time.perf_counter()
            waits.append(tb - ta)
            enqueues.append(tc - tb)
            if tc - t0 >= ctx.seconds:
                break
        sync(dev)
        rec.window_s = time.perf_counter() - t0
        rec.memory_peak_bytes = memory_peak(dev)
        rec.items = len(enqueues)
        rec.samples = rec.items * self.opt["batchSize"]
        rec.launches = {k: mdct_kernels.LAUNCHES[k] - before[k] for k in before}
        rec.spans = {"next_batch": waits, "train_step": enqueues}
        self.state = state
        if marks is not None:
            rec.spans.update(marks.spans())
            rec.trace = traced(dev, self.one_step, self.mix["trace_steps"],
                               self.mix["label_steps"])

    def one_step(self) -> None:
        with annotate("next_batch", True):
            batch = self.feed.next()
        with annotate("train_step", True):
            self.state, _ = self.step(self.state, batch)

    # -------------------------------------------------------------- check
    def release(self) -> None:
        """Free the port's state before the reference runs."""
        self.feed.close()
        self.state = self.step = None
        free(self.dev)

    def reference(self, prec: Precision = FLOAT32, batch_rows=None) -> Dict:
        """The reference (or, with ``prec``, the control) following the
        checked steps from the seeded weights on the same raw rows."""
        opt, dev = self.opt, self.dev
        reference_precision()
        with torch.device(dev):
            gen = ref_models.build_generator(opt, prec)
            disc = ref_models.Discriminator(opt, prec)
        gen.load_state_dict(self.g_sd)
        disc.load_state_dict(self.d_sd)
        tr = Transform(opt["n_fft"], opt["arcsinh_gain"], opt["src_range"],
                       opt["norm_range"], dev)
        batches = []
        for raw, rate in self.feed.taken[:CHECKED_STEPS]:
            batches.append(degrade(torch.from_numpy(raw).to(dev), rate, opt["lr_sampling_rate"],
                                   opt["hr_sampling_rate"], opt["segment_length"]))
        out = follow(gen, disc, tr, batches, opt, batch_rows)
        checks.add_norms(out)
        del gen, disc
        free(dev)
        return out

    def start_bn(self) -> Dict[str, np.ndarray]:
        """G's running statistics before step 1."""
        return {k: v.cpu().numpy() for k, v in self.g_sd.items()
                if k.endswith(("running_mean", "running_var"))}

    def check(self) -> None:
        numbers = checks.train_numbers(self.program, self.reference(), self.start_bn())
        self.rec.correct, self.rec.checks = checks.judge(numbers, self.mix["limits"])

    def finish(self) -> Record:
        self.rec.peaks = roofline.peaks_for(_kind(self.dev))
        self.rec.flops_per_item = flops.train_step_flops(self.opt, self.opt["batchSize"])
        self.release()
        self.check()
        return self.rec


def _kind(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run(ctx: Context) -> Record:
    cell = TrainCell(ctx)
    cell.setup()
    cell.window()
    return cell.finish()
