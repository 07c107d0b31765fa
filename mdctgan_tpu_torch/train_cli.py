"""The train entry point: the port of ``mdctgan_tpu/train_cli.py``.

    python -m mdctgan_tpu_torch.train_cli --dataroot TRAIN.csv \\
        --evalroot EVAL.csv ...train.sh's flags...

A background input pipeline decodes random crops of a CSV or directory
corpus (``data/pipeline.py``) and degrades each batch on the card; the
train step (``train/step.py``, K1 twice a step, or the matmul form for
the configurations K1/K2 do not serve) updates G and D; the generator is
scored on the eval corpus through the inference function (K1 and K2 once
per eval batch) into ``eval.csv``; losses go to
``loss_log.txt`` and the console, visuals to ``web/`` (and TensorBoard
with ``--tf_log``); full checkpoints (``train/checkpoint.py``) go to
``<checkpoints_dir>/<name>/ckpt/``, the latest every
``--save_latest_freq`` samples and one at the end of every
``--save_epoch_freq``-th epoch, and ``--continue_train`` resumes from the
latest.  SIGINT and SIGTERM finish the step, save, and return.

The model trains on ``cuda:<gpu_ids>`` (default 0; raises without CUDA),
with TF32 off for the whole run (``device.float32_policy``); ``--gpu_ids
-1`` asks for the CPU.  ``--fp16`` is the JAX package's bf16 policy: G and
D compute in bf16 on float32 parameters, with no loss scaling, and the
spectra, the losses and the optimizers stay float32.  Several ids and
``--multihost`` raise ``NotImplementedError``.  The TPU-form flags of the
JAX package are parsed and ignored (``options.py``).
"""

from __future__ import annotations

import os
import signal
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mdctgan_tpu_torch.data.dataset import AudioDataset
from mdctgan_tpu_torch.data.pipeline import InputPipeline
from mdctgan_tpu_torch.device import float32_policy
from mdctgan_tpu_torch.models.discriminator import build_discriminator
from mdctgan_tpu_torch.models.generator import build_generator
from mdctgan_tpu_torch.ops import mdct_kernels
from mdctgan_tpu_torch.ops.features import SpectralTransform
from mdctgan_tpu_torch.ops.metrics import compute_metrics, nanmean_rows
from mdctgan_tpu_torch.ops.resample import degrade_lr, fix_length, resample
from mdctgan_tpu_torch.options import (
    TrainOptions, serving_device, spectral_config_from_opt, train_options)
from mdctgan_tpu_torch.train import import_torch
from mdctgan_tpu_torch.train.checkpoint import CheckpointManager, state_digest
from mdctgan_tpu_torch.train.freeze import masked_optimizer, param_labels
from mdctgan_tpu_torch.train.schedule import FreqClock, carry_schedule_count, make_optimizers
from mdctgan_tpu_torch.train.state import create_train_state
from mdctgan_tpu_torch.train.step import build_inference_fn, build_train_step
from mdctgan_tpu_torch.utils import profiling
from mdctgan_tpu_torch.utils.pool import ImagePool
from mdctgan_tpu_torch.utils.spectro_img import display_spectra
from mdctgan_tpu_torch.utils.visualizer import Visualizer


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Train on ``argv`` (``sys.argv`` when None).  Returns what the run did
    and its own split by the host clock: ``state`` (the train state as the
    run left it), ``out_dir``, ``start`` (the cursor it began from),
    ``restored_digest`` (``checkpoint.state_digest`` of the state just
    after a ``--continue_train`` restore, else None), ``setup_ms``
    (options to the first step), ``steps`` (per step: its epoch, ``ms``
    from the start of its ``next(pipeline)`` to the end of its triggers,
    ``next_ms`` blocked in ``next``, and the triggers that ``fired``),
    ``losses`` (each printed step's losses), ``lrs`` (each epoch's
    learning rate at its last update), ``evals`` (each eval's ms and
    batches), ``saves`` (each save's blocking ms) and ``writes`` (each
    landed save's bytes, snapshot ms and background write ms),
    ``profile`` (``utils.profiling.report`` of the ``--profile_dir``
    window, or None) and ``launches`` (each kernel's launches in the
    run)."""
    t_start = time.perf_counter()
    launches_before = dict(mdct_kernels.LAUNCHES)
    opt = TrainOptions().parse(argv)
    train_options(opt)  # raises for --multihost
    if len(opt.gpu_ids) > 1:
        raise NotImplementedError(f"--gpu_ids {opt.gpu_ids}: data-parallel training (DDP) "
                                  "is not ported")
    dev = serving_device(opt)
    if opt.debug:
        opt.display_freq = opt.print_freq = 1
        opt.niter = 1
        opt.niter_decay = 0
        opt.max_dataset_size = 10

    # SIGINT as in the reference, and SIGTERM, what a scheduler sends at
    # preemption: finish the step, save, return
    interrupted = {"flag": False}

    def on_signal(signum, frame):
        interrupted["flag"] = True
        print(f"{signal.Signals(signum).name} received — saving and exiting after this step",
              flush=True)

    previous = {s: signal.signal(s, on_signal) for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        with float32_policy():
            result = _train(opt, dev, interrupted, t_start)
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
    result["launches"] = {k: v - launches_before[k] for k, v in mdct_kernels.LAUNCHES.items()}
    return result


def _train(opt, dev: torch.device, interrupted: Dict, t_start: float) -> Dict:
    cfg = spectral_config_from_opt(opt)
    seg, bs = cfg.segment_length, opt.batchSize
    expr_dir = os.path.join(opt.checkpoints_dir, opt.name)

    # ------------------------------------------------------------------ data
    max_files = None if opt.max_dataset_size == float("inf") else int(opt.max_dataset_size)
    train_ds = AudioDataset(opt.dataroot, seg, seed=opt.seed, max_files=max_files,
                            serial=opt.serial_batches)
    eval_ds = None
    if opt.evalroot and os.path.exists(opt.evalroot):
        eval_ds = AudioDataset(opt.evalroot, seg, seed=opt.seed, max_files=max_files,
                               serial=opt.deterministic_eval,
                               deterministic=opt.deterministic_eval)
    dataset_size = len(train_ds)
    # The reference's loader keeps the last partial batch: here every step
    # runs at batchSize and the last one of an epoch weights only its real
    # rows (``sample_mask``).  Serial batches drop it instead: masked rows
    # would make the serial cursor skip the same files every epoch.
    if opt.serial_batches:
        steps_per_epoch = max(dataset_size // bs, 1)
    else:
        steps_per_epoch = max(-(-dataset_size // bs), 1)
    last_batch_real = min(dataset_size - (steps_per_epoch - 1) * bs, bs)
    print(f"#training files = {dataset_size}")

    # ----------------------------------------------------------------- model
    transform = SpectralTransform(cfg, dev)
    generator, discriminator = build_generator(opt), build_discriminator(opt)
    g_tx, d_tx = make_optimizers(opt.lr, opt.beta1, opt.niter, opt.niter_decay,
                                 steps_per_epoch, accum_steps=opt.accum_steps)
    g_names = [n for n, _ in generator.named_parameters()]

    def g_optimizer(fix_global: bool):
        if not (fix_global or opt.freeze_g_d or opt.freeze_g_u or opt.freeze_l_d
                or opt.freeze_l_u):
            return g_tx
        return masked_optimizer(g_tx, param_labels(
            g_names, freeze_g_d=opt.freeze_g_d, freeze_g_u=opt.freeze_g_u,
            freeze_l_d=opt.freeze_l_d, freeze_l_u=opt.freeze_l_u, fix_global=fix_global))

    fix_global = opt.niter_fix_global > 0
    mgr = CheckpointManager(os.path.join(expr_dir, "ckpt"))
    if opt.continue_train and fix_global:
        # a save from after the unfreeze holds the unmasked G optimizer:
        # read its cursor first and build that one
        cursor = mgr.peek_cursor()
        if cursor is not None and cursor[0] > opt.niter_fix_global:
            fix_global = False
    state = create_train_state(generator, discriminator, g_optimizer(fix_global), d_tx,
                               device=dev, rng=torch.Generator().manual_seed(opt.seed))
    print(f"Total number of parameters of G: {state.params_count()}")

    start_epoch, epoch_iter, restored_digest = 1, 0, None
    if opt.continue_train:
        try:
            state, start_epoch, epoch_iter = mgr.restore(state, batch_size=bs)
            print(f"Resuming from epoch {start_epoch} at iteration {epoch_iter}")
            restored_digest = state_digest(state)
        except FileNotFoundError:
            print("no checkpoint found — starting fresh")
    elif opt.load_pretrain:
        key_map = opt.param_key_map or None
        g_path = os.path.join(opt.load_pretrain, f"{opt.which_epoch}_net_G.pth")
        d_path = os.path.join(opt.load_pretrain, f"{opt.which_epoch}_net_D.pth")
        if os.path.exists(g_path):
            sd, _ = import_torch.import_generator(import_torch.load_pth(g_path),
                                                  state.generator, param_key_map=key_map)
            state.generator.load_state_dict(sd, strict=True)
            print(f"imported pretrained G from {g_path}")
        if os.path.exists(d_path):
            sd, _ = import_torch.import_discriminator(
                import_torch.load_pth(d_path), state.discriminator, opt.num_D,
                opt.n_layers_D, param_key_map=key_map)
            state.discriminator.load_state_dict(sd, strict=True)
            print(f"imported pretrained D from {d_path}")

    pool = ImagePool(opt.pool_size, seed=opt.seed)
    # the masks' noise fills (a masked run without --fit_residual) draw from
    # one generator seeded by --seed, as the JAX CLI splits its key per step
    step_kw = dict(use_lsgan=not opt.no_lsgan, lambda_feat=opt.lambda_feat,
                   n_layers_d=opt.n_layers_D, num_d=opt.num_D,
                   use_ganfeat=not opt.no_ganFeat_loss, use_pool=pool.enabled,
                   noise=torch.Generator().manual_seed(opt.seed))
    step_fn = build_train_step(transform, g_optimizer(fix_global), d_tx, **step_kw)
    infer_fn = build_inference_fn(state.generator, transform, out_length=seg)
    visualizer = Visualizer(opt)
    eval_csv = os.path.join(expr_dir, "eval.csv")
    out = {"state": state, "out_dir": expr_dir,
           "start": {"epoch": start_epoch, "epoch_iter": epoch_iter},
           "restored_digest": restored_digest, "steps": [], "losses": [], "lrs": {},
           "evals": [], "saves": [], "writes": mgr.saves, "profile": None,
           "interrupted": False}

    def save(epoch: int, it: int, epoch_label: Optional[int] = None) -> None:
        # the state is copied to the host here; the file is written in the
        # background, and the next save, read or close waits for it
        t0 = time.perf_counter()
        mgr.save(state, epoch, it, epoch_label=epoch_label, accum_steps=opt.accum_steps)
        out["saves"].append({"epoch": epoch, "epoch_iter": it, "epoch_label": epoch_label,
                             "blocking_ms": (time.perf_counter() - t0) * 1e3})

    def run_eval(step: int, epoch: int) -> None:
        if eval_ds is None:
            return
        t0 = time.perf_counter()
        if opt.deterministic_eval:
            eval_ds._cursor = 0  # the same files in the same order every pass
        n = min(opt.eval_size, len(eval_ds))
        rows = []
        state.generator.eval()
        for i in range(0, n, bs):
            k = min(bs, n - i)
            hr, rates = eval_ds.sample_batch_rates(k)
            if k < bs:  # the remainder batch is padded; the metrics read k rows
                hr = np.concatenate([hr, np.zeros((bs - k, hr.shape[-1]), hr.dtype)])
                rates = np.concatenate([rates, np.full(bs - k, rates[0])])
            with torch.no_grad():
                hr_t = torch.from_numpy(hr).to(dev)
                hr_dev = lr_dev = None
                for r in np.unique(rates):  # each row at its own rate
                    h = fix_length(resample(hr_t, int(r), cfg.hr_sampling_rate), seg)
                    low = fix_length(degrade_lr(hr_t, int(r), cfg.lr_sampling_rate,
                                                cfg.hr_sampling_rate), seg)
                    if hr_dev is None:
                        hr_dev, lr_dev = h, low
                    else:
                        m = torch.from_numpy((rates == r).reshape(-1, 1)).to(dev)
                        hr_dev, lr_dev = torch.where(m, h, hr_dev), torch.where(m, low, lr_dev)
            _, sr_audio = infer_fn(lr_dev)
            m = compute_metrics(hr_dev[:k], lr_dev[:k], sr_audio[:k, ..., :seg], cfg.n_fft,
                                cfg.hop_length, cfg.win_length, cfg.center,
                                fs=cfg.hr_sampling_rate)
            rows.append({name: float(v) for name, v in m.items()})
        if rows:
            # NaN-aware: a clip's NaN snr_seg leaves the others' mean
            avg = nanmean_rows(rows)
            want = "step,epoch," + ",".join(avg)
            header = not os.path.exists(eval_csv)
            if not header:
                with open(eval_csv) as f:
                    have = f.readline().rstrip("\n")
                if have != want:
                    # other columns (an older version): keep the old file
                    # aside rather than append rows under its header
                    k = 1
                    while os.path.exists(f"{eval_csv}.bak{k}"):
                        k += 1
                    os.replace(eval_csv, f"{eval_csv}.bak{k}")
                    print(f"[eval] eval.csv columns changed; previous file kept as "
                          f"eval.csv.bak{k}")
                    header = True
            with open(eval_csv, "a") as f:
                if header:
                    f.write(want + "\n")
                f.write(f"{step},{epoch}," + ",".join(f"{v:.6f}" for v in avg.values()) + "\n")
            print(f"[eval] step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in avg.items()))
        out["evals"].append({"step": step, "batches": len(rows),
                             "ms": (time.perf_counter() - t0) * 1e3})

    mask_full = mask_tail = None
    if last_batch_real < bs:
        mask_full = torch.ones(bs, device=dev)
        mask_tail = (torch.arange(bs, device=dev) < last_batch_real).float()

    # the trigger clock counts samples, phased by a resumed run's offset
    start_samples = (start_epoch - 1) * dataset_size + epoch_iter
    clock = FreqClock(bs, start_samples, opt.print_freq, opt.display_freq,
                      opt.save_latest_freq, opt.eval_freq,
                      eval_enabled=opt.validation_split > 0)
    opt_steps = state.step
    prof, prof_t0 = None, 0.0
    pipeline = InputPipeline(train_ds, cfg, bs, add_noise=opt.add_noise, snr=opt.snr,
                             seed=opt.seed, device=dev, n_threads=opt.nThreads)
    out["setup_ms"] = (time.perf_counter() - t_start) * 1e3

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def stop_profile():
        sync()
        prof.stop()
        wall_ms = (time.perf_counter() - prof_t0) * 1e3
        os.makedirs(opt.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(opt.profile_dir, "trace.json"))
        out["profile"] = profiling.report(prof, opt.profile_nsteps, wall_ms)
        print(f"profiler trace written to {opt.profile_dir}")

    try:
        for epoch in range(start_epoch, opt.niter + opt.niter_decay + 1):
            epoch_start = time.time()
            first_iter = epoch_iter // bs if epoch == start_epoch else 0
            epoch_iter = 0
            for it in range(first_iter, steps_per_epoch):
                iter_start, t0 = time.time(), time.perf_counter()
                batch = next(pipeline)
                next_ms = (time.perf_counter() - t0) * 1e3
                is_tail = it == steps_per_epoch - 1 and mask_tail is not None
                sample_mask = mask_tail if is_tail else mask_full
                if pool.enabled:
                    shape = (bs, opt.input_nc + opt.output_nc, cfg.n_bins, cfg.n_fft // 2)
                    old, mask = pool.presample(shape)
                    state, metrics = step_fn(state, batch, torch.from_numpy(old).to(dev),
                                             torch.from_numpy(mask).to(dev), sample_mask)
                    fakes = metrics.pop("fake_concat").cpu().numpy()
                    if is_tail:  # the padding rows stay out of the pool
                        fakes = fakes[:last_batch_real]
                    pool.commit(fakes)
                else:
                    state, metrics = step_fn(state, batch, sample_mask=sample_mask)
                opt_steps += 1
                fire = clock.tick()
                total_steps = clock.total
                epoch_iter = (it + 1) * bs

                # the profiler's window, counted in steps
                if opt.profile_dir and opt_steps == opt.profile_step:
                    from torch.profiler import ProfilerActivity, profile

                    sync()
                    prof = profile(activities=[ProfilerActivity.CUDA if dev.type == "cuda"
                                               else ProfilerActivity.CPU])
                    prof.start()
                    prof_t0 = time.perf_counter()
                elif prof is not None and opt_steps >= opt.profile_step + opt.profile_nsteps:
                    stop_profile()
                    prof = None

                if fire["print"]:
                    # the JAX package prints the losses in sorted order
                    errors = {k: float(v) for k, v in sorted(metrics.items())}
                    visualizer.print_current_errors(epoch, epoch_iter, errors,
                                                    time.time() - iter_start)
                    visualizer.plot_current_errors(errors, total_steps)
                    out["losses"].append({"step": opt_steps, "epoch": epoch, **errors})
                if fire["display"]:
                    with torch.no_grad():
                        lr_spec, _, lr_np = transform.lr_forward(batch["lr_audio"][:1])
                        hr_spec, _, hr_np = transform.hr_forward(batch["hr_audio"][:1])
                    state.generator.eval()
                    sr_spec, _ = infer_fn(batch["lr_audio"][:1])
                    visualizer.display_current_results(
                        display_spectra(cfg, lr_spec, sr_spec, hr_spec, lr_np, hr_np),
                        epoch, total_steps)
                if fire["save"]:
                    save(epoch, epoch_iter)
                    print(f"saved latest (epoch {epoch}, iters {total_steps})")
                # the reference evaluates only with a validation split
                if fire["eval"]:
                    run_eval(total_steps, epoch)
                out["steps"].append({"step": opt_steps, "epoch": epoch, "next_ms": next_ms,
                                     "ms": (time.perf_counter() - t0) * 1e3,
                                     "fired": [k for k, v in fire.items() if v]})
                if interrupted["flag"]:
                    save(epoch, epoch_iter)
                    print("exiting on signal", flush=True)
                    out["interrupted"] = True
                    return out

            print(f"End of epoch {epoch} / {opt.niter + opt.niter_decay} \t "
                  f"Time Taken: {time.time() - epoch_start:.0f} sec")
            out["lrs"][epoch] = state.g_opt.param_groups[0]["lr"]
            # unfreeze the global generator after niter_fix_global: a fresh
            # G optimizer, the schedule's position kept; before the epoch's
            # save, so a save with a later epoch holds the unmasked one
            if fix_global and epoch >= opt.niter_fix_global:
                fix_global = False
                print("------------- Now also finetuning global generator -----------")
                new_g_tx = g_optimizer(False)
                state = carry_schedule_count(state, new_g_tx)
                step_fn = build_train_step(transform, new_g_tx, d_tx, **step_kw)
            if epoch % opt.save_epoch_freq == 0:
                save(epoch + 1, 0, epoch_label=epoch)
                print(f"saved model at end of epoch {epoch}")
        return out
    finally:
        if prof is not None:
            stop_profile()
        pipeline.close()
        visualizer.close()
        mgr.close()


if __name__ == "__main__":
    main()
