"""The generate cells' driver: ``generate_audio.sh``'s serving chain as one
client calls it, a closed loop of ``api.upsample(audio, rate, model,
is_lr_input=True, batch_size=...)``.

Set-up draws the generator's weights on the card from ``--seed``, builds
the model with ``api.create_model``, makes the request pool and the
request list (``traffic/mix.py``) and warms up on ``warmup_requests``
requests taken from the end of the list.  The window sends the list's
requests in order, each when the last has returned, for ``--seconds``;
each request's latency runs from its call to the return of its host
array.  The check, after the window, frees the model and serves a sample
of the finished requests (drawn from the seed, with the longest; all of
them where ``check_requests`` is 0 or at least their number) through the
plain reference.
"""

from __future__ import annotations

import math
import time
from typing import List

import numpy as np
import torch

from perfbench import checks, flops, readers, roofline
from perfbench.drivers.common import (
    Phases, annotate, free, memory_peak, reference_precision, sync, traced)
from perfbench.harness import Context, Record
from perfbench.reference import models as ref_models
from perfbench.reference.precision import FLOAT32, Precision
from perfbench.reference.serve import upsample_many
from perfbench.reference.transform import Transform
from perfbench.traffic import mix as traffic
from perfbench.weights import seeded_state_dicts

SAMPLE = 5  # the stream of the checked sample


class GenerateCell:
    def __init__(self, ctx: Context):
        self.ctx, self.dev = ctx, ctx.device
        self.opt = dict(ctx.cell.config["options"])
        self.mix = ctx.cell.traffic
        self.rec = Record("generate")

    def setup(self) -> None:
        from mdctgan_tpu_torch import api

        opt, dev, seed, mix = self.opt, self.dev, self.ctx.seed, self.mix
        phases = Phases(self.ctx.t0)
        phases.mark("start_and_imports")
        self.g_sd, _ = seeded_state_dicts(opt, dev, seed, discriminator=False)
        sync(dev)
        phases.mark("weights")
        self.model = api.create_model(opt, device=dev, state_dict=self.g_sd)
        phases.mark("create_model")
        self.waves = traffic.pool(mix, seed)
        self.requests = traffic.requests(mix, seed, self.waves)
        phases.mark("requests")
        for req in self.requests[len(self.requests) - mix["warmup_requests"]:]:
            self.serve(traffic.audio_of(req, self.waves))
        phases.mark("warmup_requests")
        seg, n = opt["segment_length"], opt["n_fft"]
        self.rec.shapes[readers.K1] = (opt["batchSize"], seg, n)
        self.rec.shapes[readers.K2] = (opt["batchSize"], seg // (n // 2) + 1, n)
        self.rec.setup_s = time.perf_counter() - self.ctx.t0
        phases.report()

    def serve(self, audio: np.ndarray) -> np.ndarray:
        from mdctgan_tpu_torch import api

        return api.upsample(audio, self.mix["rate"], self.model, is_lr_input=True,
                            gen_overlap=self.opt["gen_overlap"],
                            batch_size=self.opt["batchSize"])

    def window(self) -> None:
        from mdctgan_tpu_torch.ops import mdct_kernels

        ctx, rec, mix, opt = self.ctx, self.rec, self.mix, self.opt
        hr, seg = opt["hr_sampling_rate"], opt["segment_length"]
        up = hr // mix["rate"]
        before = dict(mdct_kernels.LAUNCHES)
        self.outputs: List[np.ndarray] = []
        queue = iter(self.requests[:len(self.requests) - mix["warmup_requests"]])
        t0 = time.perf_counter()
        for req in queue:
            audio = traffic.audio_of(req, self.waves)
            t_sent = time.perf_counter()
            out = self.serve(audio)
            done = time.perf_counter()
            rec.latencies_s.append(done - t_sent)
            self.outputs.append(out)
            rec.audio_out_s += len(out) / hr
            rec.segments += max(1, math.ceil(len(audio) * up / seg))
            if done - t0 >= ctx.seconds:
                break
        else:
            raise RuntimeError("the request list ran out before the window closed")
        rec.window_s = time.perf_counter() - t0
        rec.memory_peak_bytes = memory_peak(self.dev)
        rec.items = len(self.outputs)
        rec.launches = {k: mdct_kernels.LAUNCHES[k] - before[k] for k in before}
        if ctx.trace:
            def one():
                with annotate("request", True):
                    self.serve(traffic.audio_of(next(queue), self.waves))

            rec.trace = traced(self.dev, one, mix["trace_requests"], mix["label_requests"])

    def sample(self) -> List[int]:
        """The checked requests: drawn from the seed, with the longest."""
        n, k = len(self.outputs), self.mix["check_requests"]
        if k == 0 or k >= n:
            return list(range(n))
        rng = np.random.default_rng([int(self.ctx.seed), SAMPLE])
        longest = max(range(n), key=lambda i: self.requests[i].length)
        rest = [i for i in rng.permutation(n).tolist() if i != longest][:k - 1]
        return sorted([longest, *rest])

    def release(self) -> None:
        self.model = None
        free(self.dev)

    def reference(self, which: List[int], prec: Precision = FLOAT32) -> List[np.ndarray]:
        opt, dev = self.opt, self.dev
        reference_precision()
        with torch.device(dev):
            gen = ref_models.build_generator(opt, prec)
        gen.load_state_dict(self.g_sd)
        tr = self.transform = Transform(opt["n_fft"], opt["arcsinh_gain"], opt["src_range"],
                                        opt["norm_range"], dev)
        out = upsample_many([traffic.audio_of(self.requests[i], self.waves) for i in which],
                            self.mix["rate"], gen, tr, opt, dev, opt["batchSize"])
        del gen
        free(dev)
        return out

    def spectrum(self, wave: np.ndarray) -> np.ndarray:
        """A waveform's normalised spectrum by the reference's transform."""
        with torch.no_grad():
            return self.transform.spectrum(torch.as_tensor(wave, device=self.dev)[None]).cpu().numpy()

    def check(self) -> None:
        which = self.sample()
        numbers = checks.serve_numbers([self.outputs[i] for i in which], self.reference(which),
                                       self.spectrum)
        self.rec.correct, self.rec.checks = checks.judge(numbers, self.mix["limits"])

    def finish(self) -> Record:
        dev = self.dev
        self.rec.peaks = roofline.peaks_for(
            torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
        self.rec.flops_per_item = flops.generator_flops(self.opt)
        self.release()
        self.check()
        return self.rec


def run(ctx: Context) -> Record:
    cell = GenerateCell(ctx)
    cell.setup()
    cell.window()
    return cell.finish()
