"""The generate entry point: the port of ``mdctgan_tpu/generate_cli.py``.

    python -m mdctgan_tpu_torch.generate_cli --load_pretrain DIR \\
        --dataroot (FILE | DIR | LIST.csv) ...spectral and generator flags...

Each file is read and DC-shifted, degraded to LR (down to
``--lr_sampling_rate`` and back up) or, with ``--is_lr_input``, only
resampled to the HR rate, optionally given SNR-calibrated noise
(``--add_noise``, drawn from a ``torch.Generator`` seeded by ``--seed``),
cut into segments, run through K1 -> G -> K2 (or the matmul form, for the
configurations K1/K2 do not serve: ``ops/features.py``) in batches of
``--batchSize`` (``api.serve_segments``; the dB mode's pseudo-phase drawn
from one generator per batch, ``phase_generators``), stitched, and scored
(MSE, SNR of SR and LR, segmental SNR, LSD) against the input at the HR
rate, on the model's device.

A single audio path is the reference's mode: ``metric.txt`` and
``sr_audio.wav``, ``lr_audio.wav``, ``hr_audio.wav`` in
``<checkpoints_dir>/<name>``.  A directory or a ``.csv``/``.txt`` list
serves the whole corpus with one model load: ``<stem>_sr.wav`` per file
(de-duplicated names) and ``metrics.csv`` with a NaN-aware ``MEAN`` row; a
file that cannot be read is skipped.

The model runs on ``cuda:<gpu_ids>`` (default 0; raises without CUDA);
``--gpu_ids -1`` asks for the CPU.  Several ids serve data-parallel in this
process, one generator replica a card and each segment batch split over
them (``api.replicate``; the JAX CLI's mesh), unless ``--batchSize`` does
not divide by their number: then it says so and serves on the first card.  ``--fp16`` serves with the bf16
generator (``models/layers.py``); the transforms stay float32.  Weights
come from ``<load_pretrain>/<which_epoch>_net_G.pth`` in the reference's
key layout, or from the ``ckpt/`` of a run of the port's train CLI.
"""

from __future__ import annotations

import csv
import os
import time
import wave
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mdctgan_tpu_torch import api
from mdctgan_tpu_torch.data import native
from mdctgan_tpu_torch.data.dataset import AudioTestDataset, list_audio_files
from mdctgan_tpu_torch.device import float32_policy
from mdctgan_tpu_torch.ops.features import SpectralConfig
from mdctgan_tpu_torch.ops.metrics import compute_metrics, nanmean_rows
from mdctgan_tpu_torch.ops.resample import add_noise_snr, degrade_lr, resample
from mdctgan_tpu_torch.options import TrainOptions, serving_devices, spectral_config_from_opt
from mdctgan_tpu_torch.parallel.mesh import make_mesh
from mdctgan_tpu_torch.train.restore import load_generator_state


class AudioLoadError(RuntimeError):
    """An input file that cannot be read: reported (single-file mode) or
    skipped (batch mode), unlike a device error, which propagates."""


def _expand_dataroot(dataroot: str) -> Tuple[List[str], bool]:
    """(paths, batch_mode).  A directory or a ``.csv``/``.txt`` list is
    batch mode, whatever its size; a plain audio path is single-file
    mode."""
    if os.path.isdir(dataroot) or dataroot.lower().endswith((".csv", ".txt")):
        paths = list_audio_files(dataroot)
        if not paths:
            raise SystemExit(f"no audio files in {dataroot}")
        return paths, True
    return [dataroot], False


def phase_generators(cfg: SpectralConfig,
                     seed: int) -> Optional[Callable[[int], torch.Generator]]:
    """The dB mode's pseudo-phase source, as the JAX CLI feeds one key per
    batch (``fold_in(PRNGKey(seed), i)``): ``i -> `` a CPU generator seeded
    from (``seed``, ``i``), ``i`` the batch's first segment; None where
    ``to_audio`` draws no phase (arcsinh, raw, explicit, or no upsampling).
    The draws are made on the CPU and moved, so the card and the CPU draw
    the same signs."""
    if cfg.arcsinh_transform or cfg.raw_mdct or cfg.explicit_encoding or cfg.up_ratio <= 1:
        return None

    def phase(i: int) -> torch.Generator:
        state = np.random.SeedSequence([seed, i]).generate_state(2, np.uint32)
        return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))

    return phase


def _process_file(path: str, opt, cfg: SpectralConfig, model: api.Model,
                  replicas: Optional[List[api.Model]] = None):
    """One file through degrade -> segment -> G (``model``, or each of
    ``replicas``) -> stitch -> metrics, on ``model``'s device.  Returns
    (sr, lr, hr, hr_rate, metrics)."""
    try:
        ds = AudioTestDataset(path, cfg.segment_length, overlap=opt.gen_overlap)
    except (OSError, EOFError, ValueError, wave.Error) as e:
        raise AudioLoadError(f"load audio failed: {path}") from e
    dev = model.device
    print(f"Audio length: {ds.audio_len}")
    with torch.inference_mode(), float32_policy():
        raw = torch.from_numpy(ds.raw_audio)[None].to(dev)
        if opt.is_lr_input:
            lr_audio = resample(raw, ds.in_sampling_rate, cfg.hr_sampling_rate)
        else:
            lr_audio = degrade_lr(raw, ds.in_sampling_rate, cfg.lr_sampling_rate,
                                  cfg.hr_sampling_rate)
        if opt.add_noise:
            lr_audio = add_noise_snr(lr_audio, opt.snr, cfg.segment_length,
                                     torch.Generator().manual_seed(opt.seed))
        lr_np = lr_audio[0].cpu().numpy()
        segments = ds.segments_of(lr_np)
        print(f"#audio segments = {len(segments)}")
        sr = ds.stitch(api.serve_segments(replicas or model, segments, opt.batchSize,
                                          phase_generators(cfg, opt.seed)))

        # The reference signal at the HR rate: the raw input where the rates
        # agree (the reference's own crop), else resampled to it, so the
        # comparison is rate-consistent and the SR keeps its full duration.
        if ds.in_sampling_rate == cfg.hr_sampling_rate:
            hr_ref, hr_rate = ds.raw_audio, ds.in_sampling_rate
        else:
            hr_ref = resample(raw, ds.in_sampling_rate, cfg.hr_sampling_rate)[0].cpu().numpy()
            hr_rate = cfg.hr_sampling_rate
        audio_len = min(len(hr_ref), len(sr), len(lr_np))
        hr = hr_ref[:audio_len]
        m = compute_metrics(
            *(torch.from_numpy(np.ascontiguousarray(a[:audio_len]))[None].to(dev)
              for a in (hr, lr_np, sr)),
            cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.center,
            fs=cfg.hr_sampling_rate)
        metrics = {k: float(v) for k, v in m.items()}
    print(f"MSE: {metrics['mse']:.4f}")
    print(f"SNR_SR: {metrics['snr_sr']:.4f}")
    print(f"SNR_LR: {metrics['snr_lr']:.4f}")
    print(f"SNR_SEG: {metrics['snr_seg']:.4f}")
    print(f"LSD: {metrics['lsd']:.4f}")
    return sr[:audio_len], lr_np[:audio_len], hr, hr_rate, metrics


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the CLI on ``argv`` (``sys.argv`` when None).  Returns what it
    did: ``rungs`` (the weight import's fallback rungs, ``[]`` for a strict
    load), ``rows`` (batch mode: one dict per file written), ``out_dir``,
    and this run's split by the host clock: ``setup_ms`` (options, model,
    weights) and ``file_ms`` (each file written: its ``_process_file`` and
    its WAVs; each ends in a read of its metrics, which waits for the
    device)."""
    t0 = time.perf_counter()
    opt = TrainOptions().parse(argv, save=False)
    devices = serving_devices(opt)
    if len(devices) > 1 and opt.batchSize % len(devices):
        print(f"[mesh] batchSize {opt.batchSize} not divisible by {len(devices)} "
              "devices — serving on 1 device")
        devices = devices[:1]
    cfg = spectral_config_from_opt(opt)
    model = api.create_model(opt, devices[0])
    state, rungs = load_generator_state(opt, model.generator)
    model.generator.load_state_dict(state, strict=True)
    replicas = [model]
    if len(devices) > 1:
        replicas = api.replicate(model, make_mesh(devices))
        print(f"[mesh] data-parallel serving over {len(devices)} devices")
    expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
    os.makedirs(expr_dir, exist_ok=True)
    paths, batch_mode = _expand_dataroot(opt.dataroot)
    setup_ms = (time.perf_counter() - t0) * 1e3
    file_ms = {}

    if not batch_mode:
        t0 = time.perf_counter()
        try:
            sr, lr, hr, hr_rate, m = _process_file(paths[0], opt, cfg, model, replicas)
        except AudioLoadError:
            raise SystemExit("load audio failed")
        with open(os.path.join(expr_dir, "metric.txt"), "w") as f:
            f.write("MSE,SNR_SR,LSD\n")
            f.write(f"{m['mse']:f},{m['snr_sr']:f},{m['lsd']:f}")
        native.write_wav16(os.path.join(expr_dir, "sr_audio.wav"), sr, cfg.hr_sampling_rate)
        native.write_wav16(os.path.join(expr_dir, "lr_audio.wav"), lr, cfg.hr_sampling_rate)
        native.write_wav16(os.path.join(expr_dir, "hr_audio.wav"), hr, hr_rate)
        file_ms[paths[0]] = (time.perf_counter() - t0) * 1e3
        return {"rungs": rungs, "rows": [], "out_dir": expr_dir, "setup_ms": setup_ms,
                "file_ms": file_ms}

    rows = []
    used_names = set()
    for path in paths:
        print(f"=== {path}")
        t0 = time.perf_counter()
        try:
            sr, _, _, _, m = _process_file(path, opt, cfg, model, replicas)
        except AudioLoadError as e:
            print(f"[batch] skipping: {e}")
            continue
        stem = os.path.splitext(os.path.basename(path))[0]
        name, k = f"{stem}_sr.wav", 1
        while name in used_names:
            name, k = f"{stem}_{k}_sr.wav", k + 1
        used_names.add(name)
        native.write_wav16(os.path.join(expr_dir, name), sr, cfg.hr_sampling_rate)
        rows.append({"file": path, "output": name, **m})
        file_ms[path] = (time.perf_counter() - t0) * 1e3
    if not rows:
        raise SystemExit("no file in the corpus could be processed")
    mean = nanmean_rows([{k: v for k, v in r.items() if k not in ("file", "output")}
                         for r in rows])
    with open(os.path.join(expr_dir, "metrics.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
        w.writerow({"file": "MEAN", **mean})
    print(f"[batch] {len(rows)}/{len(paths)} files -> {expr_dir}/metrics.csv "
          f"(mean LSD {mean['lsd']:.4f}, mean SNR_SR {mean['snr_sr']:.4f})")
    return {"rungs": rungs, "rows": rows, "out_dir": expr_dir, "setup_ms": setup_ms,
            "file_ms": file_ms}


if __name__ == "__main__":
    main()
