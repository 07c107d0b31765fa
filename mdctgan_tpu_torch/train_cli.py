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
spectra, the losses and the optimizers stay float32.  The TPU-form flags of
the JAX package are parsed and ignored (``options.py``).

Data parallelism (``parallel/mesh.py``), with the JAX package's global-batch
semantics: a global batch split over ranks steps as the same batch on one
rank.  ``--gpu_ids a,b,..`` starts one rank a listed card of this host, and
``--batchSize`` is the global batch, split over them; ``--multihost`` joins
the group that torchrun started (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` or
``--coordinator_address``), on ``cuda:<LOCAL_RANK>``, and ``--batchSize``
is each host's batch, split over the host's ranks.  Every rank holds the
whole state and reads its host's batch from the same seeded stream; rank 0
alone writes ``opt.txt``, the logs, the visuals, the checkpoints and
``eval.csv``, evaluates and displays, and ranks agree on a signal each
step, so all stop at the same step.
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
    TrainOptions, serving_devices, spectral_config_from_opt, write_options)
from mdctgan_tpu_torch.parallel import mesh
from mdctgan_tpu_torch.train import import_torch
from mdctgan_tpu_torch.train.checkpoint import CheckpointManager, state_digest
from mdctgan_tpu_torch.train.freeze import masked_optimizer, param_labels
from mdctgan_tpu_torch.train.schedule import FreqClock, carry_schedule_count, make_optimizers
from mdctgan_tpu_torch.train.state import create_train_state, replicate_state
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
    ``next_ms`` blocked in ``next``, ``agree_ms`` spent agreeing on a
    signal across ranks (0 without ranks), and the triggers that
    ``fired``), ``losses`` (each printed step's losses), ``lrs`` (each
    epoch's learning rate at its last update), ``evals`` (each eval's ms and
    batches), ``saves`` (each save's blocking ms) and ``writes`` (each
    landed save's bytes, snapshot ms and background write ms),
    ``profile`` (``utils.profiling.report`` of the ``--profile_dir``
    window, or None; the window traces the host beside the card, which
    slows the host, so its idle share reads higher than a card-only
    trace's) and ``launches`` (each kernel's launches in the
    run).  Under ``--multihost``, this rank's.  With several ``--gpu_ids``,
    rank 0's, with ``state`` replaced by its ``digest``, the launches summed
    over the ranks, and ``ranks``: each rank's, the same way."""
    t_start = time.perf_counter()
    opt = TrainOptions().parse(argv, save=False)
    if not opt.multihost:  # under --multihost, rank 0 alone writes it
        write_options(opt)
    devices = serving_devices(opt)
    if opt.multihost:  # on cuda:<LOCAL_RANK>, or the CPU with --gpu_ids -1
        ranks = mesh.init_multihost(devices[0].type, opt.coordinator_address or None)
        print(f"multihost: rank {ranks.rank}/{ranks.world} on {ranks.device}", flush=True)
        try:
            if ranks.is_main:
                write_options(opt)
            _debug_overrides(opt)
            return _run(opt, ranks.device, ranks, t_start)
        finally:
            torch.distributed.destroy_process_group()
    cards = [d for d in devices if d.type == "cuda"]
    if len(set(cards)) < len(cards):  # NCCL refuses two ranks on one card
        raise ValueError(f"--gpu_ids {opt.gpu_ids}: every rank needs a card of its own")
    _debug_overrides(opt)
    if len(devices) == 1:
        return _run(opt, devices[0], None, t_start)
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()  # the ranks' memory comes from the same cards
    results = mesh.spawn(_spawned_rank, devices, args=(opt, t_start))
    return {**results[0], "ranks": results,
            "launches": {k: sum(r["launches"][k] for r in results)
                         for k in mdct_kernels.LAUNCHES}}


def _debug_overrides(opt) -> None:
    """``--debug``: one short epoch, printing and displaying every step (after
    ``opt.txt`` is written, which records the flags as given)."""
    if opt.debug:
        opt.display_freq = opt.print_freq = 1
        opt.niter = 1
        opt.niter_decay = 0
        opt.max_dataset_size = 10


def _spawned_rank(ranks: mesh.Ranks, opt, t_start: float) -> Dict:
    """One rank of ``--gpu_ids a,b,..`` (``mesh.spawn``): its result, with
    the state's ``digest`` in place of the state."""
    result = _run(opt, ranks.device, ranks, t_start)
    result["digest"] = state_digest(result.pop("state"))
    return result


def _run(opt, dev: torch.device, ranks: Optional[mesh.Ranks], t_start: float) -> Dict:
    """The run on this process's device, under its own float32 policy and
    signal handlers."""
    launches_before = dict(mdct_kernels.LAUNCHES)

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
            result = _train(opt, dev, ranks, interrupted, t_start)
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
    result["launches"] = {k: v - launches_before[k] for k, v in mdct_kernels.LAUNCHES.items()}
    return result


def _train(opt, dev: torch.device, ranks: Optional[mesh.Ranks], interrupted: Dict,
           t_start: float) -> Dict:
    cfg = spectral_config_from_opt(opt)
    # bs, the host's batch, sets the epoch and the trigger clock; each rank
    # steps on its share of it
    seg, bs = cfg.segment_length, opt.batchSize
    if ranks is not None:
        ranks.host_rows(bs)  # raises where the host's ranks do not divide it
    is_main = ranks is None or ranks.is_main
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
    mgr = CheckpointManager(os.path.join(expr_dir, "ckpt"), writer=is_main)
    if opt.continue_train and fix_global:
        # a save from after the unfreeze holds the unmasked G optimizer:
        # read its cursor first and build that one
        cursor = mgr.peek_cursor()
        if cursor is not None and cursor[0] > opt.niter_fix_global:
            fix_global = False
    state = create_train_state(generator, discriminator, g_optimizer(fix_global), d_tx,
                               device=dev, rng=torch.Generator().manual_seed(opt.seed),
                               ranks=ranks)
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
    if ranks is not None and (opt.continue_train or opt.load_pretrain):
        replicate_state(state, ranks)

    pool = ImagePool(opt.pool_size, seed=opt.seed)
    # the masks' noise fills (a masked run without --fit_residual) draw from
    # one generator seeded by --seed, as the JAX CLI splits its key per step
    step_kw = dict(use_lsgan=not opt.no_lsgan, lambda_feat=opt.lambda_feat,
                   n_layers_d=opt.n_layers_D, num_d=opt.num_D,
                   use_ganfeat=not opt.no_ganFeat_loss, use_pool=pool.enabled,
                   noise=torch.Generator().manual_seed(opt.seed), ranks=ranks)
    step_fn = build_train_step(transform, g_optimizer(fix_global), d_tx, **step_kw)
    infer_fn = build_inference_fn(state.generator, transform, out_length=seg)
    visualizer = Visualizer(opt, is_main=is_main)
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
        if ranks is not None:  # no rank runs ahead of rank 0's snapshot
            mesh.barrier(ranks)
        out["saves"].append({"epoch": epoch, "epoch_iter": it, "epoch_label": epoch_label,
                             "blocking_ms": (time.perf_counter() - t0) * 1e3})

    def run_eval(step: int, epoch: int) -> None:
        # rank 0 alone, on its copy of the weights: no collective on this path
        if eval_ds is None or not is_main:
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

    # the host batch's tail mask, and this rank's rows of it
    host_tail = np.arange(bs) < last_batch_real
    mask_full = mask_tail = None
    if last_batch_real < bs:
        mask_full = mesh.put_global_batch({"m": torch.ones(bs, device=dev)}, ranks)["m"]
        mask_tail = mesh.put_global_batch(
            {"m": torch.from_numpy(host_tail.astype(np.float32)).to(dev)}, ranks)["m"]

    # the trigger clock counts samples, phased by a resumed run's offset
    start_samples = (start_epoch - 1) * dataset_size + epoch_iter
    clock = FreqClock(bs, start_samples, opt.print_freq, opt.display_freq,
                      opt.save_latest_freq, opt.eval_freq,
                      eval_enabled=opt.validation_split > 0)
    opt_steps = state.step
    prof, prof_t0 = None, 0.0
    pipeline = InputPipeline(train_ds, cfg, bs, add_noise=opt.add_noise, snr=opt.snr,
                             seed=opt.seed, device=dev, n_threads=opt.nThreads, ranks=ranks)
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

    completed = False
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
                    # the global batch's decisions, the same on every rank
                    # (one seed); each rank mixes its rows, and every rank
                    # commits every rank's fakes
                    hosts = 1 if ranks is None else ranks.hosts
                    shape = (bs * hosts, opt.input_nc + opt.output_nc, cfg.n_bins,
                             cfg.n_fft // 2)
                    old, mask = pool.presample(shape)
                    if ranks is not None:
                        b = batch["lr_audio"].shape[0]
                        first, _ = ranks.global_rows(b)
                        old, mask = old[first:first + b], mask[first:first + b]
                    state, metrics = step_fn(state, batch, torch.from_numpy(old).to(dev),
                                             torch.from_numpy(mask).to(dev), sample_mask)
                    fakes = metrics.pop("fake_concat")
                    if ranks is not None:
                        fakes = mesh.gather_rows(fakes, ranks)
                    # the padding rows stay out of the pool
                    pool.commit(fakes.cpu().numpy(),
                                keep=np.tile(host_tail, hosts) if is_tail else None)
                else:
                    state, metrics = step_fn(state, batch, sample_mask=sample_mask)
                opt_steps += 1
                fire = clock.tick()
                total_steps = clock.total
                epoch_iter = (it + 1) * bs

                # the profiler's window, counted in steps, on rank 0
                if opt.profile_dir and is_main and opt_steps == opt.profile_step:
                    from torch.profiler import ProfilerActivity, profile

                    sync()
                    # the host's activity too: the step's spans over the card's
                    prof = profile(activities=[ProfilerActivity.CPU] + (
                        [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
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
                if fire["display"] and is_main:
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
                # every rank stops at the same step: a signal to any one
                # stops them all
                t_agree = time.perf_counter()
                stop = interrupted["flag"]
                if ranks is not None:
                    stop = mesh.any_rank(stop, ranks)
                agree_ms = (time.perf_counter() - t_agree) * 1e3
                out["steps"].append({"step": opt_steps, "epoch": epoch, "next_ms": next_ms,
                                     "ms": (time.perf_counter() - t0) * 1e3,
                                     "agree_ms": agree_ms,
                                     "fired": [k for k, v in fire.items() if v]})
                if stop:
                    save(epoch, epoch_iter)
                    print("exiting on signal", flush=True)
                    out["interrupted"] = True
                    completed = True
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
        completed = True
        return out
    finally:
        if prof is not None:
            stop_profile()
        pipeline.close()
        visualizer.close()
        mgr.close()
        if completed and ranks is not None:  # none leaves before rank 0's last write lands
            mesh.barrier(ranks)


if __name__ == "__main__":
    main()
