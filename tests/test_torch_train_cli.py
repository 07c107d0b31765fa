"""The port's train entry point against the JAX package's on the CPU.

The two CLIs run side by side once per module (fixtures; JAX's with
``sys.argv`` patched): the same seeded G and D written as reference-layout
``.pth`` files and loaded by ``--load_pretrain``, serial batches, a fixed
eval crop, no noise, 2 epochs of 2 Adam steps, and an eval of 3 files in
batches of 2 (a padded remainder batch).  Held against each other: the
loss lines, ``eval.csv``, the final generator read back from each one's
checkpoint, the cursor and epoch index, and the rotation of a stale
``eval.csv``.  Both CLIs again with ``--accum_steps 4`` across the
``niter_fix_global`` unfreeze, from a local generator, held update by
update.  Then the port alone: a resume that restores the first run's
state bit for bit, a SIGTERM, a ``--fp16`` run and its resume, the
refusals, ``generate_cli`` from the port's checkpoint, the visualizer, the
display spectra, the HTML page and the profile reader.

Sizes: the geometry of ``tests/test_cli.py``'s train smoke test (n_fft
128, 8128-sample segments, ``netG global`` ngf 4, one resblock and one
attention block, a 2-scale discriminator of ndf 4 and 2 layers), batch 2.
"""

import argparse
import csv
import json
import re
import shutil
import signal
import subprocess
import sys
import time
import types
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import optax
import pytest
import torch

from mdctgan_tpu import train_cli as jcli
from mdctgan_tpu.models.discriminator import MultiscaleDiscriminator as JMultiscaleDiscriminator
from mdctgan_tpu.models.generator import build_generator as j_build_generator
from mdctgan_tpu.options import TrainOptions as JTrainOptions
from mdctgan_tpu.train import import_torch as jimp
from mdctgan_tpu.train import schedule as jschedule
from mdctgan_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from mdctgan_tpu.utils import html as jhtml
from mdctgan_tpu.utils.spectro_img import display_spectra as j_display_spectra
from mdctgan_tpu.utils.visualizer import Visualizer as JVisualizer

from mdctgan_tpu_torch import generate_cli, train_cli
from mdctgan_tpu_torch.data import native as tnative
from mdctgan_tpu_torch.models.discriminator import build_discriminator
from mdctgan_tpu_torch.models.generator import build_generator
from mdctgan_tpu_torch.ops.features import SpectralTransform
from mdctgan_tpu_torch.options import TrainOptions, spectral_config_from_opt
from mdctgan_tpu_torch.train.checkpoint import CheckpointManager, state_digest
from mdctgan_tpu_torch.train.restore import load_generator_state
from mdctgan_tpu_torch.train.schedule import OptimizerSpec, pix2pixhd_lr_schedule
from mdctgan_tpu_torch.train.state import create_train_state
from mdctgan_tpu_torch.train.step import build_train_step
from mdctgan_tpu_torch.utils import html as thtml
from mdctgan_tpu_torch.utils import profiling
from mdctgan_tpu_torch.utils.spectro_img import display_spectra
from mdctgan_tpu_torch.utils.visualizer import Visualizer
from mdctgan_tpu_torch.weights import state_dict_from_jax

from test_torch_models import _flax_vars
from test_torch_serve import _BANNED

ROOT = Path(__file__).resolve().parents[1]
GEOMETRY = [
    "--lr_sampling_rate", "16000", "--center", "--arcsinh_transform",
    "--abs_spectro", "--abs_norm", "--norm_range", "-1", "1",
    "--fit_residual", "--netG", "global", "--ngf", "4",
    "--n_downsample_global", "2", "--n_blocks_global", "1",
    "--n_blocks_attn_g", "1", "--heads_g", "2", "--dim_head_g", "4",
    "--segment_length", "8128", "--n_fft", "128", "--hop_length", "64",
    "--win_length", "128", "--bins", "128", "--batchSize", "2",
    "--num_D", "2", "--n_layers_D", "2", "--ndf", "4", "--jax_cache_dir", "",
]
RUN = [
    "--serial_batches", "--deterministic_eval", "--niter", "1", "--niter_decay", "1",
    "--print_freq", "2", "--eval_freq", "4", "--eval_size", "3", "--save_latest_freq", "4",
    "--save_epoch_freq", "1", "--display_freq", "1000000", "--nThreads", "1",
]
STEPS, LR = 4, 2e-4  # 2 epochs of 2 steps at the default lr
STALE = "step,epoch,mse,snr_sr,snr_lr,lsd\n1,1,0.5,1.0,1.0,2.0\n"
LOSS_LINE = re.compile(r"^\(epoch: (\d+), iters: (\d+), time: [\d.]+\) (.*)$")


# --------------------------------------------------------------------------
# the corpus, the weights and each CLI run once
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(9)
    (root / "wav").mkdir()
    names = []
    for i, n in enumerate((16000, 17500, 19000, 20500, 22000, 16500, 18000, 21000)):
        t = np.arange(n) / 48000
        x = sum(0.1 / k * np.sin(2 * np.pi * 170 * k * t + i) for k in range(1, 8))
        x = (x + 0.01 * rng.standard_normal(n)).astype(np.float32)
        tnative.write_wav16(str(root / "wav" / f"s{i}.wav"), x, 48000)
        names.append(f"wav/s{i}.wav")
    (root / "train.csv").write_text("\n".join(names[:5]) + "\n")
    (root / "eval.csv").write_text("\n".join(names[5:]) + "\n")

    jopt = JTrainOptions().parse(GEOMETRY + ["--checkpoints_dir", str(root / "unused")],
                                 save=False)
    flax_g = j_build_generator(jopt)
    g_params, g_stats = _flax_vars(flax_g, np.zeros((1, 2, 128, 64), np.float32), rng,
                                   train=False)
    # a damped head keeps the SR band small, as a trained model's is
    g_params["head"]["conv"] = {k: v * 0.01 for k, v in g_params["head"]["conv"].items()}
    flax_d = JMultiscaleDiscriminator(ndf=4, n_layers=2, num_D=2)
    d_params, _ = _flax_vars(flax_d, np.zeros((1, 3, 128, 64), np.float32), rng)
    pretrain = root / "pretrained"
    pretrain.mkdir()
    for name, tree, stats, entries in (
            ("G", g_params, g_stats, jimp.generator_entries_for(flax_g)),
            ("D", d_params, {}, jimp.discriminator_entries(2, 2))):
        sd = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
              for k, v in jimp.export_to_torch_keys(tree, stats, entries).items()}
        torch.save(sd, pretrain / f"latest_net_{name}.pth")
    return dict(root=root, pretrain=pretrain, g_params=g_params, g_stats=g_stats)


def _args(corpus, out, name, gpu_ids="-1", html=False):
    root = corpus["root"]
    return GEOMETRY + RUN + [
        "--dataroot", str(root / "train.csv"), "--evalroot", str(root / "eval.csv"),
        "--load_pretrain", str(corpus["pretrain"]), "--checkpoints_dir", str(out),
        "--name", name, "--gpu_ids", gpu_ids] + ([] if html else ["--no_html"])


def _stale_eval_csv(run_dir):
    run_dir.mkdir(parents=True)
    (run_dir / "eval.csv").write_text(STALE)


@pytest.fixture(scope="module")
def jax_run(corpus):
    out = corpus["root"] / "jax"
    _stale_eval_csv(out / "run")
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        with mock.patch.object(sys, "argv", ["train.py"] + _args(corpus, out, "run", "0")):
            jcli.main()
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    return out / "run"


@pytest.fixture(scope="module")
def port_run(corpus):
    out = corpus["root"] / "port"
    _stale_eval_csv(out / "run")
    return out / "run", train_cli.main(_args(corpus, out, "run"))


def _loss_lines(run_dir):
    rows = []
    for line in (run_dir / "loss_log.txt").read_text().splitlines()[1:]:
        epoch, iters, rest = LOSS_LINE.match(line).groups()
        parts = rest.split()
        values = {parts[i].rstrip(":"): float(parts[i + 1]) for i in range(0, len(parts), 2)}
        rows.append(((int(epoch), int(iters)), values))
    return rows


def _eval_rows(run_dir):
    with open(run_dir / "eval.csv") as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


# --------------------------------------------------------------------------
# the two CLIs side by side
# --------------------------------------------------------------------------

def test_train_cli_losses_match_jax(jax_run, port_run):
    """Every printed loss line: the same epoch, iteration and losses in the
    same order, each value within 2e-3 of JAX's (3 decimals printed)."""
    got, ref = _loss_lines(port_run[0]), _loss_lines(jax_run)
    assert len(got) == len(ref) == STEPS
    for (pos, values), (ref_pos, ref_values) in zip(got, ref):
        assert pos == ref_pos and list(values) == list(ref_values)
        for k, v in values.items():
            assert abs(v - ref_values[k]) <= 2e-3, (pos, k, v, ref_values[k])


def test_train_cli_eval_matches_jax(jax_run, port_run):
    """``eval.csv``: the header, each row's step and epoch, LSD within 1e-3
    relative, each SNR within 0.01 dB, MSE within 1e-2 relative."""
    (names, rows), (ref_names, ref_rows) = _eval_rows(port_run[0]), _eval_rows(jax_run)
    assert names == ref_names == ["step", "epoch", "mse", "snr_sr", "snr_lr", "snr_seg", "lsd"]
    assert [(r["step"], r["epoch"]) for r in rows] == [(r["step"], r["epoch"])
                                                       for r in ref_rows] == [("4", "1"),
                                                                              ("8", "2")]
    for row, ref in zip(rows, ref_rows):
        for k in names[2:]:
            g, r = float(row[k]), float(ref[k])
            assert np.isfinite(g)
            bound = 0.01 if k.startswith("snr") else {"lsd": 1e-3, "mse": 1e-2}[k] * abs(r)
            assert abs(g - r) <= bound, (row["step"], k, g, r)


def test_train_cli_rotates_a_stale_eval_csv(jax_run, port_run):
    for run_dir in (jax_run, port_run[0]):
        assert (run_dir / "eval.csv.bak1").read_text() == STALE
        assert not (run_dir / "eval.csv.bak2").exists()


def test_train_cli_final_generator_matches_jax(corpus, jax_run, port_run):
    """The generator each run saved last, read back through each package's
    own partial restore: within ``test_adam_trajectory_matches_jax``'s
    bounds, grown with the steps (RMS 0.05 lr a step for every tensor whose
    gradient is not f32 dust, 2.5 lr (steps + 1) at its largest: each Adam
    step moves an element by ~lr whatever its gradient's size, so every
    element whose f32 gradient changes sign between the two adds ~2 lr, and
    over 4 steps on different batches the worst tensor reads ~0.11 lr), and
    the BatchNorm running statistics within 1e-4."""
    mgr = JCheckpointManager(str(jax_run / "ckpt"))
    sub = mgr.restore_fields({"g_params": corpus["g_params"], "batch_stats": corpus["g_stats"]})
    mgr.close()
    ref = state_dict_from_jax(sub["g_params"], sub["batch_stats"])
    opt = TrainOptions().parse(GEOMETRY, save=False)
    gen = build_generator(opt)
    got = CheckpointManager(str(port_run[0] / "ckpt")).restore_fields(
        {"generator": gen.state_dict()})["generator"]
    assert got.keys() == ref.keys()

    # which tensors hold f32 dust: those one SGD(1) step does not move
    sgd = OptimizerSpec(lambda p: torch.optim.SGD(p, lr=1.0))
    gen.load_state_dict(state_dict_from_jax(corpus["g_params"], corpus["g_stats"]))
    state = create_train_state(gen, build_discriminator(opt), sgd, sgd, device="cpu",
                               rng=None)
    before = {n: p.detach().clone() for n, p in gen.named_parameters()}
    x = torch.from_numpy((0.1 * np.random.default_rng(3).standard_normal((2, 8128)))
                         .astype(np.float32))
    build_train_step(SpectralTransform(spectral_config_from_opt(opt), "cpu"), sgd, sgd,
                     n_layers_d=2, num_d=2)(state, {"lr_audio": x, "hr_audio": x})
    params = dict(gen.named_parameters())
    for name, want in ref.items():
        diff = (got[name] - want).double()
        if name not in params:  # a BatchNorm running statistic
            assert float(diff.abs().max()) <= 1e-4, name
            continue
        if float((params[name].detach() - before[name]).pow(2).mean().sqrt()) >= 1e-5:
            rms = float(diff.pow(2).mean().sqrt())
            assert rms <= 0.05 * LR * STEPS, f"{name}: RMS {rms:.3e}"
        assert float(diff.abs().max()) <= 2.5 * LR * (STEPS + 1), name


def test_train_cli_cursor_and_index_match_jax(jax_run, port_run):
    """The same latest step, cursor and epoch index: the epoch-end save of
    epoch 2 lands on the step the latest save already holds, and both keep
    that save's cursor."""
    mgr = JCheckpointManager(str(jax_run / "ckpt"))
    ref = (mgr.latest_step(), mgr.peek_cursor(), mgr.resolve_epoch(1), mgr.resolve_epoch(2))
    mgr.close()
    ours = CheckpointManager(str(port_run[0] / "ckpt"))
    assert (ours.latest_step(), ours.peek_cursor(), ours.resolve_epoch(1),
            ours.resolve_epoch(2)) == ref == (4, (2, 4), 2, 4)
    assert (port_run[0] / "ckpt" / "epoch_index.json").read_text() == \
        (jax_run / "ckpt" / "epoch_index.json").read_text()


def test_train_cli_returns_its_own_split(port_run):
    _, r = port_run
    assert [s["step"] for s in r["steps"]] == [1, 2, 3, 4]
    assert [s["fired"] for s in r["steps"]] == [["print"], ["print", "save", "eval"]] * 2
    assert all(s["ms"] >= s["next_ms"] >= 0 for s in r["steps"])
    assert r["setup_ms"] > 0 and len(r["evals"]) == 2
    assert all(e["batches"] == 2 and e["ms"] > 0 for e in r["evals"])
    assert [s["epoch_label"] for s in r["saves"]] == [None, 1, None, 2]
    assert [w["step"] for w in r["writes"]] == [2, 4] and all(w["bytes"] > 0 for w in r["writes"])
    sched = pix2pixhd_lr_schedule(LR, 1, 1, 2)
    assert r["lrs"] == {1: sched(1), 2: sched(3)}
    assert r["launches"] == {k: 0 for k in r["launches"]}  # the CPU runs the plain versions
    assert r["state"].step == STEPS and r["restored_digest"] is None
    assert [row["step"] for row in r["losses"]] == [1, 2, 3, 4]
    assert r["profile"] is None and not r["interrupted"]


# --------------------------------------------------------------------------
# the port alone
# --------------------------------------------------------------------------

def test_train_cli_resume_restores_the_run_bit_for_bit(corpus, port_run, tmp_path, capsys):
    """``--continue_train`` on a copy of the run: it resumes at the saved
    cursor with the state the first run ended with, bit for bit, and trains
    the third epoch, with displays (``web/``) and a profile window."""
    shutil.copytree(port_run[0], tmp_path / "run")
    args = _args(corpus, tmp_path, "run", html=True) + [
        "--continue_train", "--niter_decay", "2", "--display_freq", "2",
        "--profile_dir", str(tmp_path / "prof"), "--profile_step", "5",
        "--profile_nsteps", "1"]
    r = train_cli.main(args)
    out = capsys.readouterr().out
    assert "Resuming from epoch 2 at iteration 4" in out
    assert r["start"] == {"epoch": 2, "epoch_iter": 4}
    assert r["restored_digest"] == state_digest(port_run[1]["state"])
    assert [s["step"] for s in r["steps"]] == [5, 6] and r["state"].step == 6
    assert r["profile"]["steps"] == 1 and r["profile"]["device_busy_ms"] is None
    # the host's activity is traced, so the step's spans are on its timeline
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert {"step", "step.backward"} <= {e.get("name") for e in trace["traceEvents"]}
    assert (tmp_path / "run" / "web" / "images").is_dir()
    assert CheckpointManager(str(tmp_path / "run" / "ckpt")).peek_cursor() == (3, 4)


def test_train_cli_sigterm_saves_and_exits(corpus, tmp_path):
    """SIGTERM, what a scheduler sends at preemption: the run finishes its
    step, saves, and exits 0, in an interpreter that never imported JAX."""
    args = _args(corpus, tmp_path, "term") + ["--niter", "500", "--niter_decay", "0",
                                              "--eval_freq", "1000000",
                                              "--save_latest_freq", "1000000"]
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['train_cli'] + {args!r}\n"
        "runpy.run_module('mdctgan_tpu_torch.train_cli', run_name='__main__')\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {_BANNED!r})\n"
        "assert not bad, bad\n"
        "print('no JAX imported')\n")
    log = tmp_path / "term.log"
    with open(log, "w") as lf:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=lf,
                                stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 120
            while time.time() < deadline and proc.poll() is None:
                if "End of epoch 1" in log.read_text(errors="replace"):
                    break
                time.sleep(0.2)
            assert proc.poll() is None, log.read_text(errors="replace")[-3000:]
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    text = log.read_text(errors="replace")
    assert rc == 0, text[-3000:]
    assert "SIGTERM received" in text and "exiting on signal" in text
    assert "no JAX imported" in text
    mgr = CheckpointManager(str(tmp_path / "term" / "ckpt"))
    epoch, it = mgr.peek_cursor()
    assert epoch >= 2 and it > 0  # mid-epoch: the signal's own save


@pytest.mark.parametrize("extra,error,match", [
    ([], RuntimeError, "CUDA"),
    (["--gpu_ids", "0,1"], RuntimeError, "CUDA"),
    (["--gpu_ids", "-1", "--multihost"], ValueError, "RANK"),
])
def test_train_cli_refuses_what_is_not_ported(corpus, tmp_path, monkeypatch, extra, error,
                                              match):
    """The default ``--gpu_ids 0`` without CUDA raises (never a silent
    CPU), and so do several ids; ``--multihost`` outside a launch that
    names the ranks (torchrun's variables) raises."""
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(corpus, tmp_path, "x")
    i = args.index("--gpu_ids")
    del args[i: i + 2]
    with pytest.raises(error, match=match):
        train_cli.main(args + extra)


def test_train_cli_options_file_records_the_flags_as_given(corpus, tmp_path, monkeypatch):
    """``opt.txt`` is written as parsing wrote it in the reference: before
    ``--debug``'s overrides and before the device is chosen (here the
    default ``--gpu_ids 0`` without CUDA, which then raises)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(corpus, tmp_path, "dbg")
    i = args.index("--gpu_ids")
    del args[i: i + 2]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(args + ["--debug"])
    lines = (tmp_path / "dbg" / "opt.txt").read_text().splitlines()
    for line in ("debug: True", "niter_decay: 1", "print_freq: 2", "display_freq: 1000000"):
        assert line in lines


def test_train_cli_fp16_trains_and_resumes(corpus, tmp_path, capsys):
    """``--fp16``, as ``train.sh`` passes it: G and D compute in bf16 on
    float32 parameters, the losses are float32 and finite, and
    ``--continue_train`` restores the run's state bit for bit and trains on
    in bf16."""
    r = train_cli.main(_args(corpus, tmp_path, "fp16") + ["--fp16"])
    state = r["state"]
    assert state.generator.compute_dtype is torch.bfloat16
    assert state.discriminator.scale0.layer0.compute_dtype is torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state.generator.parameters())
    assert len(r["losses"]) == STEPS and all(np.isfinite(v) for row in r["losses"]
                                             for k, v in row.items() if k not in ("step", "epoch"))
    assert (tmp_path / "fp16" / "eval.csv").exists()
    again = train_cli.main(_args(corpus, tmp_path, "fp16") + ["--fp16", "--continue_train",
                                                              "--niter_decay", "2"])
    assert "Resuming from epoch 2 at iteration 4" in capsys.readouterr().out
    assert again["restored_digest"] == state_digest(state)
    assert again["state"].step == STEPS + 2
    assert again["state"].generator.compute_dtype is torch.bfloat16


# --------------------------------------------------------------------------
# gradient accumulation across the niter_fix_global unfreeze, both CLIs
# --------------------------------------------------------------------------

LOCAL = ["--netG", "local", "--n_blocks_local", "1"]
# 2 steps an epoch, 4 micro-batches an update, the unfreeze after epoch 3
# (step 6, half way through D's second update), 6 epochs decaying from the
# first: D updates at steps 4, 8, 12 (counts 0, 1, 2); G at step 4 (count 0)
# and, in a fresh window from step 6, at step 10 (count 1)
ACCUM = ["--accum_steps", "4", "--niter_fix_global", "3", "--niter", "0", "--niter_decay", "6",
         "--eval_freq", "1000000", "--save_latest_freq", "1000000", "--save_epoch_freq", "100"]


@pytest.fixture(scope="module")
def accum_runs(corpus):
    """The JAX and the port's train CLI with ``ACCUM`` from the same local
    generator and discriminator: per step, whether each net moved, its
    learning rate at that update, and its parameters."""
    root = corpus["root"] / "accum"
    opt = JTrainOptions().parse(GEOMETRY + LOCAL + ["--checkpoints_dir", str(root / "unused")],
                                save=False)
    flax_g = j_build_generator(opt)
    rng = np.random.default_rng(21)
    g_params, g_stats = _flax_vars(flax_g, np.zeros((1, 2, 128, 64), np.float32), rng,
                                   train=False)
    g_params["local_head"]["conv"] = {k: v * 0.01
                                      for k, v in g_params["local_head"]["conv"].items()}
    pretrain = root / "pretrained"
    pretrain.mkdir(parents=True)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in
          jimp.export_to_torch_keys(g_params, g_stats, jimp.generator_entries_for(flax_g)).items()}
    torch.save(sd, pretrain / "latest_net_G.pth")
    shutil.copy(corpus["pretrain"] / "latest_net_D.pth", pretrain / "latest_net_D.pth")

    def args(out):
        return _args(dict(corpus, pretrain=pretrain), root / out, "run") + LOCAL + ACCUM

    sched = jschedule.pix2pixhd_lr_schedule(LR, 0, 6, 1)

    def counts(opt_state):
        return [int(c.count) for c in jax.tree.leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByScheduleState))
            if isinstance(c, optax.ScaleByScheduleState)][0]

    jax_steps, real_jbuild = [], jcli.build_train_step

    def j_build(*a, **k):
        inner = real_jbuild(*a, **k)

        def step(state, *args, **kw):
            before = (counts(state.g_opt_state), counts(state.d_opt_state))
            new, metrics = inner(state, *args, **kw)
            after = (counts(new.g_opt_state), counts(new.d_opt_state))
            g, d = jax.device_get((new.g_params, new.d_params))
            jax_steps.append({
                "moved": {"G": after[0] > before[0], "D": after[1] > before[1]},
                "lr": {"G": float(sched(before[0])), "D": float(sched(before[1]))},
                "params": {"G": {k: v.numpy() for k, v in state_dict_from_jax(g, {}).items()},
                           "D": {k: v.numpy() for k, v in state_dict_from_jax(d, {}).items()}}})
            return new, metrics
        return step

    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        with mock.patch.object(jcli, "build_train_step", j_build), \
                mock.patch.object(sys, "argv", ["train.py"] + args("jax")):
            jcli.main()
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)

    port_steps, real_build = [], train_cli.build_train_step

    def build(*a, **k):
        inner = real_build(*a, **k)

        def step(state, *args, **kw):
            before = {n: [p.detach().clone() for p in m.parameters()]
                      for n, m in (("G", state.generator), ("D", state.discriminator))}
            state, metrics = inner(state, *args, **kw)
            nets = {"G": (state.generator, state.g_opt), "D": (state.discriminator, state.d_opt)}
            port_steps.append({
                "moved": {n: any(not torch.equal(b, p) for b, p in zip(before[n], m.parameters()))
                          for n, (m, _) in nets.items()},
                "lr": {n: o.param_groups[0]["lr"] for n, (_, o) in nets.items()},
                "params": {n: {k: v.detach().clone().numpy() for k, v in m.named_parameters()}
                           for n, (m, _) in nets.items()}})
            return state, metrics
        return step

    with mock.patch.object(train_cli, "build_train_step", build):
        train_cli.main(args("port"))
    return jax_steps, port_steps, opt


def test_accumulation_across_the_unfreeze_matches_jax(accum_runs):
    """``--accum_steps 4 --niter_fix_global 3`` with 2 steps an epoch, so
    the unfreeze falls half way through an update.  As JAX's fresh
    ``optax.MultiSteps``: G's partial gradients are dropped at the
    unfreeze, G steps on the 4th call after it while D's window runs on,
    and G's learning rate is read at its own update count, carried across.
    The same nets move at the same steps with the same learning rates, the
    global branch only after the unfreeze, and after the net's n-th update
    its parameters are within the bounds of
    ``test_gradient_accumulation_matches_jax_multisteps`` with a wider RMS:
    2.5 lr (n + 1) at the largest, and RMS 0.15 lr n for every tensor whose
    gradient is not f32 dust.  Adam's first steps move each element by ~lr
    times the sign of its gradient, and at this geometry more elements
    than at that test's change sign between two f32 runs: the worst RMS
    reads 0.083 lr at G's first update and 0.108 lr at its second (the
    largest differences 1.99 lr).  A G that kept D's window would step at
    steps 4, 8 and 12."""
    jax_steps, port_steps, opt = accum_runs
    assert len(jax_steps) == len(port_steps) == 12
    moved = {net: [i + 1 for i, s in enumerate(port_steps) if s["moved"][net]]
             for net in ("G", "D")}
    assert moved == {net: [i + 1 for i, s in enumerate(jax_steps) if s["moved"][net]]
                     for net in ("G", "D")} == {"G": [4, 10], "D": [4, 8, 12]}
    sched = pix2pixhd_lr_schedule(LR, 0, 6, 1)
    want_lr = {"G": {4: sched(0), 10: sched(1)}, "D": {4: sched(0), 8: sched(1), 12: sched(2)}}

    # which tensors hold f32 dust: those one SGD(1) step does not move
    gen, disc = build_generator(opt), build_discriminator(opt)
    gen.load_state_dict({k: torch.from_numpy(v) for k, v in port_steps[0]["params"]["G"].items()},
                        strict=False)
    sgd = OptimizerSpec(lambda p: torch.optim.SGD(p, lr=1.0))
    state = create_train_state(gen, disc, sgd, sgd, device="cpu",
                               rng=torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in [*gen.named_parameters(),
                                                 *disc.named_parameters()]}
    x = torch.from_numpy((0.1 * np.random.default_rng(3).standard_normal((2, 8128)))
                         .astype(np.float32))
    build_train_step(SpectralTransform(spectral_config_from_opt(opt), "cpu"), sgd, sgd,
                     n_layers_d=2, num_d=2)(state, {"lr_audio": x, "hr_audio": x})
    params = dict([*gen.named_parameters(), *disc.named_parameters()])
    dust = {n: float((params[n].detach() - before[n]).pow(2).mean().sqrt()) < 1e-5
            for n in before}

    first = {net: port_steps[0]["params"][net] for net in ("G", "D")}
    for net in ("G", "D"):
        for n, step in enumerate(moved[net], start=1):
            got, ref = port_steps[step - 1], jax_steps[step - 1]
            assert got["lr"][net] == pytest.approx(want_lr[net][step], rel=1e-6)
            assert ref["lr"][net] == pytest.approx(want_lr[net][step], rel=1e-6)
            for name, value in got["params"][net].items():
                diff = value.astype(np.float64) - ref["params"][net][name]
                if not dust[name]:
                    rms = float(np.sqrt(np.mean(diff ** 2)))
                    assert rms <= 0.15 * LR * n, f"{net} update {n} {name}: RMS {rms:.3e}"
                assert float(np.abs(diff).max()) <= 2.5 * LR * (n + 1), (net, n, name)
    for i in range(5):  # the global branch is frozen until the unfreeze
        for s in (port_steps[i], jax_steps[i]):
            for name, value in s["params"]["G"].items():
                if name.startswith("global."):
                    assert np.array_equal(value, jax_steps[0]["params"]["G"][name]) or \
                        np.array_equal(value, first["G"][name]), (i, name)


def test_generate_cli_reads_a_port_checkpoint(corpus, jax_run, port_run, tmp_path):
    """``--load_pretrain <run dir>`` serves the generator the port trained,
    from its ``ckpt/`` (``--which_epoch`` through the epoch index), loaded
    strictly; the JAX package's orbax ``ckpt/`` is still refused."""
    run_dir, _ = port_run
    mgr = CheckpointManager(str(run_dir / "ckpt"))
    opt = TrainOptions().parse(GEOMETRY + ["--load_pretrain", str(run_dir),
                                           "--checkpoints_dir", str(tmp_path)], save=False)
    gen = build_generator(opt)
    for which, step in (("latest", 4), ("1", 2)):
        opt.which_epoch = which
        state, rungs = load_generator_state(opt, gen)
        want = mgr.restore_fields({"generator": gen.state_dict()}, step=step)["generator"]
        assert rungs == [] and all(torch.equal(state[k], want[k]) for k in want)
    r = generate_cli.main(GEOMETRY + [
        "--gpu_ids", "-1", "--load_pretrain", str(run_dir), "--checkpoints_dir", str(tmp_path),
        "--name", "gen", "--dataroot", str(corpus["root"] / "wav" / "s6.wav")])
    assert r["rungs"] == [] and (tmp_path / "gen" / "sr_audio.wav").exists()
    opt.load_pretrain = str(jax_run)
    with pytest.raises(SystemExit, match="orbax"):
        load_generator_state(opt, gen)


def test_visualizer_lines_match_jax(tmp_path, capsys):
    """The same console and ``loss_log.txt`` lines as the JAX package's
    visualizer for the same losses, a zero (inactive) one left out."""
    lines = {}
    for name, cls in (("jax", JVisualizer), ("port", Visualizer)):
        opt = argparse.Namespace(name=name, checkpoints_dir=str(tmp_path), no_html=True,
                                 tf_log=False, isTrain=True, display_winsize=256)
        (tmp_path / name).mkdir()
        vis = cls(opt)
        vis.print_current_errors(3, 40, {"D_fake": 0.25, "G_GAN": 1.5, "G_GAN_Feat": 0.0,
                                         "loss_G": np.float32(12.3456)}, 0.1234)
        vis.plot_current_errors({"D_fake": 0.25}, 40)
        vis.display_current_results({"lr_spectro": np.zeros((4, 4))}, 3, 40)
        vis.close()
        lines[name] = (capsys.readouterr().out,
                       (tmp_path / name / "loss_log.txt").read_text().splitlines())
    assert lines["port"][0] == lines["jax"][0]
    assert lines["port"][1][1:] == lines["jax"][1][1:] == [
        "(epoch: 3, iters: 40, time: 0.123) D_fake: 0.250 G_GAN: 1.500 loss_G: 12.346 "]
    assert lines["port"][1][0].startswith("================ Training Loss (")


@pytest.mark.parametrize("arcsinh,explicit", [(True, False), (False, False), (True, True)])
def test_display_spectra_matches_jax(rng, arcsinh, explicit):
    """SR denormalized with the LR bounds and clipped to HR's range (1e-6),
    and the raw and explicit modes' pass-throughs."""
    cfg = types.SimpleNamespace(arcsinh_transform=arcsinh, explicit_encoding=explicit,
                                norm_range=(-1.0, 1.0))
    specs = [rng.uniform(-1.2, 1.2, (1, 2, 32, 64)).astype(np.float32) for _ in range(3)]
    lr_np, hr_np = {"min": -5.0, "max": 5.0}, {"min": -4.0, "max": 3.5}
    ref = j_display_spectra(cfg, *specs, lr_np, hr_np)
    got = display_spectra(cfg, *(torch.from_numpy(s) for s in specs), lr_np, hr_np)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arcsinh,explicit", [(True, False), (False, False), (True, True)])
def test_display_spectra_per_sample_bounds_match_jax(rng, arcsinh, explicit):
    """Per-sample bounds (``abs_norm`` off): (B, C, 1, 1) tensors on the
    port's side, arrays on JAX's, as each package's ``to_spectro`` returns
    them."""
    cfg = types.SimpleNamespace(arcsinh_transform=arcsinh, explicit_encoding=explicit,
                                norm_range=(-1.0, 1.0))
    specs = [rng.uniform(-1.2, 1.2, (2, 2, 32, 64)).astype(np.float32) for _ in range(3)]
    bounds = [{"min": rng.uniform(-6, -4, (2, 2, 1, 1)).astype(np.float32),
               "max": rng.uniform(3, 5, (2, 2, 1, 1)).astype(np.float32)} for _ in range(2)]
    ref = j_display_spectra(cfg, *specs, *bounds)
    got = display_spectra(cfg, *(torch.from_numpy(s) for s in specs),
                          *({k: torch.from_numpy(v) for k, v in b.items()} for b in bounds))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), atol=1e-6, err_msg=k)


def test_html_page_matches_jax(tmp_path):
    for name, mod in (("jax", jhtml), ("port", thtml)):
        page = mod.HTML(str(tmp_path / name), "Experiment = x <y>", refresh=30)
        page.add_header("epoch [2]")
        page.add_images(["a.jpg", "b.jpg"], ["a", "b&c"], width=256)
        page.add_header("epoch [1]")
        page.save()
    assert (tmp_path / "port" / "index.html").read_text() == \
        (tmp_path / "jax" / "index.html").read_text()
    assert (tmp_path / "port" / "images").is_dir()


def test_profiling_reads_the_device_intervals():
    """Busy time is the union of the device records' intervals (overlaps
    counted once, annotations left out), the span runs from the first
    start to the last end, the report's idle share is busy time against
    the host's wall time, and its kernels are device records alone."""
    from torch.autograd import DeviceType

    def event(a, b, device=DeviceType.CUDA, annotation=False):
        return types.SimpleNamespace(device_type=device, is_user_annotation=annotation,
                                     time_range=types.SimpleNamespace(start=a, end=b))

    class Prof:
        def events(self):
            return [event(0, 1000), event(500, 1500), event(3000, 4000),
                    event(0, 9000, annotation=True), event(0, 9000, DeviceType.CPU)]

        def key_averages(self):  # a host operation carries its kernels' device time
            return [types.SimpleNamespace(key="k1", count=4, self_device_time_total=2000.0,
                                          device_type=DeviceType.CUDA),
                    types.SimpleNamespace(key="cpu_op", count=9, self_device_time_total=2500.0,
                                          device_type=DeviceType.CPU)]

    prof = Prof()
    assert profiling.busy_time_ms(prof, 2) == pytest.approx(1.25)
    assert profiling.step_device_time_ms(prof, 2) == pytest.approx(2.0)
    r = profiling.report(prof, 2, wall_ms=5.0)
    assert r["device_idle_share"] == pytest.approx(0.5) and r["device_records"] == 3
    assert r["top"] == [{"name": "k1", "count": 2.0, "ms": 1.0}]
    empty = types.SimpleNamespace(events=lambda: [])
    assert profiling.busy_time_ms(empty) is None
    assert profiling.report(empty, 1, 1.0)["device_idle_share"] is None

