"""The port's data parallelism against one rank and against the JAX mesh,
on the CPU over gloo.

The JAX package's claim (``tests/test_train_step.py::
test_dp_invariance_1_vs_8_devices``): the same global batch on one device
and on several gives the same losses and the same update, up to float32
reduction order.  Here two ranks (``parallel.mesh.spawn``, once per module)
each step on their rows of one global batch of 8 whose tail mask keeps 6
rows, so the ranks keep 4 and 2: the BatchNorm statistics and the loss
means are the global batch's only if the ranks sum them.  The step is held
to one rank on the whole batch, to the JAX step on ``make_mesh(2)``, and
per-rank averaging (what a plain ``DistributedDataParallel`` would give) is
held to differ by more than the bound.  Then serving over a two-entry CPU
mesh, the draws at the global shape, the input pipeline's rows, the pool's
commit, two ``--multihost`` train-CLI ranks (two processes, torchrun's
variables) against one process, and the refusal of ids this host has no
card for.

Sizes: the small LocalEnhancer of ``test_torch_models.py`` with one
attention block on a (32, 64) spectrum and the 2-scale discriminator of
``test_torch_train.py``; the train CLI at ``test_torch_train_cli.py``'s
geometry, batch 2.
"""

import functools
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from mdctgan_tpu import api as japi
from mdctgan_tpu.data.dataset import AudioDataset as JAudioDataset
from mdctgan_tpu.models.discriminator import MultiscaleDiscriminator as JMultiscaleDiscriminator
from mdctgan_tpu.models.generator import LocalEnhancer as JLocalEnhancer
from mdctgan_tpu.ops.features import SpectralConfig as JSpectralConfig
from mdctgan_tpu.ops.features import SpectralTransform as JSpectralTransform
from mdctgan_tpu.parallel.mesh import make_mesh as j_make_mesh
from mdctgan_tpu.parallel.mesh import replicate as j_replicate
from mdctgan_tpu.train.state import GANTrainState as JGANTrainState
from mdctgan_tpu.train.step import build_inference_fn as j_build_inference_fn
from mdctgan_tpu.train.step import build_train_step as j_build_train_step

from mdctgan_tpu_torch import api as tapi
from mdctgan_tpu_torch import generate_cli, train_cli
from mdctgan_tpu_torch.data import native as tnative
from mdctgan_tpu_torch.data.dataset import AudioDataset
from mdctgan_tpu_torch.data.pipeline import InputPipeline
from mdctgan_tpu_torch.models.discriminator import MultiscaleDiscriminator
from mdctgan_tpu_torch.models.generator import LocalEnhancer
from mdctgan_tpu_torch.ops.features import SpectralConfig, SpectralTransform
from mdctgan_tpu_torch.parallel import mesh
from mdctgan_tpu_torch.train.schedule import OptimizerSpec
from mdctgan_tpu_torch.train.state import create_train_state
from mdctgan_tpu_torch.train.step import build_train_step
from mdctgan_tpu_torch.utils.pool import ImagePool
from mdctgan_tpu_torch.weights import state_dict_from_jax

import _torch_parallel_worker as worker
from test_torch_models import SMALL_LOCAL, _flax_vars
from test_torch_serve import OPT, _clip
from test_torch_serve import SPECTRAL as SERVE_SPECTRAL
from test_torch_serve import _weights as _serve_weights
from test_torch_train import (
    D_CFG, HW, SPECTRAL, _assert_losses, _assert_normwise, _assert_stats, _jax_deltas)
from test_torch_train_cli import GEOMETRY

ROOT = Path(__file__).resolve().parents[1]
B = 8
MASK = (np.arange(B) < 6).astype(np.float32)  # rank 0 keeps 4 rows, rank 1 keeps 2
LOSS_RTOL, LOSS_ATOL = 5e-5, 1e-6  # test_dp_invariance_1_vs_8_devices' bounds
UPDATE_REL = 2e-4  # of the tree's largest movement, as there
SPAWN_DEADLINE_S = 240


# --------------------------------------------------------------------------
# one global batch: one rank, two ranks, the JAX mesh
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def env():
    rng = np.random.default_rng(21)
    flax_g = JLocalEnhancer(**SMALL_LOCAL)
    flax_d = JMultiscaleDiscriminator(**D_CFG)
    g_params, g_stats = _flax_vars(flax_g, np.zeros((1, 2, *HW), np.float32), rng,
                                   train=False)
    d_params, _ = _flax_vars(flax_d, np.zeros((1, 3, *HW), np.float32), rng)
    t = SPECTRAL["segment_length"]
    hr = (0.1 * rng.standard_normal((B, t))).astype(np.float32)
    lr = (hr + 0.01 * rng.standard_normal((B, t))).astype(np.float32)
    return dict(flax_g=flax_g, flax_d=flax_d, g_params=g_params, g_stats=g_stats,
                d_params=d_params, batch={"lr_audio": lr, "hr_audio": hr},
                g_sd=state_dict_from_jax(g_params, g_stats),
                d_sd=state_dict_from_jax(d_params, {}))


def _one_rank(env, rows=slice(None)):
    """The port's step as one process on ``rows`` of the batch (no group):
    metrics and the state after it, as the worker returns them."""
    sgd = OptimizerSpec(functools.partial(torch.optim.SGD, lr=1.0))
    gen, disc = LocalEnhancer(**SMALL_LOCAL), MultiscaleDiscriminator(3, **D_CFG)
    gen.load_state_dict(env["g_sd"], strict=True)
    disc.load_state_dict(env["d_sd"], strict=True)
    state = create_train_state(gen, disc, sgd, sgd, device="cpu")
    step = build_train_step(SpectralTransform(SpectralConfig(**SPECTRAL), "cpu"), sgd, sgd,
                            n_layers_d=D_CFG["n_layers"], num_d=D_CFG["num_D"])
    state, metrics = step(state, {k: torch.from_numpy(v[rows]) for k, v in env["batch"].items()},
                          sample_mask=torch.from_numpy(MASK[rows]))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "generator": {k: v.numpy() for k, v in state.generator.state_dict().items()},
            "discriminator": {k: v.numpy() for k, v in state.discriminator.state_dict().items()}}


@pytest.fixture(scope="module")
def one_rank(env):
    return _one_rank(env)


@pytest.fixture(scope="module")
def two_ranks(env):
    """Each rank's result of the same step over gloo: two processes, each
    on its rows of the batch."""
    return mesh.spawn(worker.sgd_step, ["cpu", "cpu"],
                      args=(env["g_sd"], env["d_sd"], SMALL_LOCAL, D_CFG, SPECTRAL,
                            env["batch"], MASK),
                      deadline_s=SPAWN_DEADLINE_S)


@pytest.fixture(scope="module")
def jax_mesh(env):
    """The JAX step on ``make_mesh(2)``: replicated state, the batch and its
    mask sharded over the two devices."""
    sgd = optax.sgd(1.0)
    jt = JSpectralTransform(JSpectralConfig(**SPECTRAL), use_fused=False)
    step = j_build_train_step(env["flax_g"], env["flax_d"], jt, sgd, sgd,
                              n_layers_d=D_CFG["n_layers"], num_d=D_CFG["num_D"],
                              donate=False)
    state = JGANTrainState(
        step=jnp.zeros((), jnp.int32), g_params=env["g_params"], d_params=env["d_params"],
        batch_stats=env["g_stats"], g_opt_state=sgd.init(env["g_params"]),
        d_opt_state=sgd.init(env["d_params"]))
    jmesh = j_make_mesh(2)
    rows = NamedSharding(jmesh, PartitionSpec("data"))
    batch = {k: jax.device_put(v, rows) for k, v in env["batch"].items()}
    state, metrics = step(j_replicate(state, jmesh), batch, jax.random.PRNGKey(1),
                          sample_mask=jax.device_put(MASK, rows))
    return jax.device_get((state.g_params, state.batch_stats, state.d_params, metrics))


def _movement(before, after_a, after_b):
    """(the tree's largest |before - after_a|, at least 1; the largest
    |after_a - after_b|), over the trainable tensors of a state dict."""
    scale, err = 1.0, 0.0
    for k in before:
        if k.endswith(("running_mean", "running_var")):
            continue
        b = before[k].numpy()
        scale = max(scale, float(np.abs(b - after_a[k]).max()))
        err = max(err, float(np.abs(after_a[k] - after_b[k]).max()))
    return scale, err


def _running_stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def test_two_ranks_step_as_one_rank(env, one_rank, two_ranks):
    """World size 2 against world size 1 on one global batch with a masked
    tail: the losses within ``test_dp_invariance_1_vs_8_devices``' bounds,
    the SGD(1) update (the gradient) within 2e-4 of the tree's movement,
    G's BatchNorm running statistics, and the same state bit for bit on
    both ranks."""
    a, b = two_ranks
    assert a["digest"] == b["digest"]
    for k, v in one_rank["metrics"].items():
        np.testing.assert_allclose(a["metrics"][k], v, rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=k)
    for net, sd in (("generator", env["g_sd"]), ("discriminator", env["d_sd"])):
        scale, err = _movement(sd, one_rank[net], a[net])
        assert err <= UPDATE_REL * scale, f"{net}: {err:.3e} vs scale {scale:.3e}"
    stats = _running_stats(one_rank["generator"])
    assert stats  # the attention stack's BatchNorm
    for k, v in stats.items():
        np.testing.assert_allclose(a["generator"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_per_rank_averaging_differs_beyond_the_bound(env, one_rank):
    """The control: each rank on its own rows without the group (local
    BatchNorm statistics, local means), averaged as a plain
    ``DistributedDataParallel`` averages, misses the global step by more
    than the bounds above, so they can tell."""
    halves = [_one_rank(env, slice(0, 4)), _one_rank(env, slice(4, 8))]
    worst = max(abs(np.mean([h["metrics"][k] for h in halves]) - v)
                / (LOSS_ATOL + LOSS_RTOL * abs(v)) for k, v in one_rank["metrics"].items())
    assert worst > 10, worst
    averaged = {k: np.mean([h["generator"][k] for h in halves], axis=0)
                for k in one_rank["generator"]}
    scale, err = _movement(env["g_sd"], one_rank["generator"], averaged)
    assert err > 10 * UPDATE_REL * scale, (err, scale)


def test_two_ranks_match_the_jax_mesh(env, two_ranks, jax_mesh):
    """The port's two ranks against the JAX step on a 2-device mesh, at
    ``test_torch_train.py``'s bounds for one SGD(1) step against JAX."""
    g_after, stats, d_after, metrics = jax_mesh
    got = two_ranks[0]
    _assert_losses(metrics, got["metrics"], 5e-3)
    ref_g, ref_d = _jax_deltas(env, g_after, d_after)
    for ref, net, sd in ((ref_g, "generator", env["g_sd"]),
                         (ref_d, "discriminator", env["d_sd"])):
        deltas = {k: sd[k].numpy() - got[net][k] for k in ref}
        _assert_normwise(ref, deltas, 2e-3, 5e-5, net)
    gen = LocalEnhancer(**SMALL_LOCAL)
    gen.load_state_dict({k: torch.from_numpy(v) for k, v in got["generator"].items()})
    _assert_stats(stats, gen, 1e-5)


def test_collectives_gather_and_agree(two_ranks):
    """``gather_rows`` gives every rank's rows in rank order on every rank;
    ``any_rank`` the same answer on every rank."""
    for r in two_ranks:
        assert r["gathered"] == [0.0, 0.0, 1.0, 1.0]
        assert r["any_odd"] is True


# --------------------------------------------------------------------------
# serving over replicas, and the draws at the global shape
# --------------------------------------------------------------------------

def test_upsample_over_a_two_entry_mesh(rng):
    """``api.upsample(mesh=...)`` over two CPU replicas against one device
    and against JAX's ``upsample(mesh=make_mesh(2))``; a batch that the
    mesh does not divide raises, as in JAX."""
    flax_g, g_vars, sd = _serve_weights(rng)
    seg = SERVE_SPECTRAL["segment_length"]
    cfg = JSpectralConfig(**SERVE_SPECTRAL)
    jt = JSpectralTransform(cfg, use_fused=False)
    j_model = japi.Model(flax_g, None, jt, None, None,
                         j_build_inference_fn(flax_g, jt, out_length=seg))
    clip = _clip(rng, int(2.6 * seg), 48000)
    ref = japi.upsample(clip, 48000, g_vars, j_model, gen_overlap=256, batch_size=2,
                        mesh=j_make_mesh(2))
    model = tapi.create_model(OPT, device="cpu", state_dict=sd)
    two = mesh.make_mesh(["cpu", "cpu"])
    got = tapi.upsample(clip, 48000, model, gen_overlap=256, batch_size=2, mesh=two)
    single = tapi.upsample(clip, 48000, model, gen_overlap=256, batch_size=2)
    assert got.shape == single.shape == ref.shape
    scale = float(np.abs(ref).max())
    # a replica convolves a batch of 1 where one device convolves 2: float32
    # rounding, carried through the sinh (read: 4.5e-6 of the largest value)
    np.testing.assert_allclose(got, single, atol=5e-5 * scale)
    np.testing.assert_allclose(got, ref, atol=2e-3 * scale)
    replicas = tapi.replicate(model, two)
    assert replicas[0] is model and replicas[1].generator is not model.generator
    with pytest.raises(ValueError, match="not divisible by mesh size 2"):
        tapi.upsample(clip, 48000, model, batch_size=3, mesh=two)


DB = dict(SERVE_SPECTRAL, arcsinh_transform=False, abs_norm=False, abs_spectro=False,
          fit_residual=False, mask=True)


@pytest.mark.parametrize("draw", ["noise_fill", "pseudo_phase"])
def test_draws_at_the_global_shape(rng, draw):
    """A call on some rows of a global batch (``rows``) draws what the
    whole batch draws on one device, for those rows: the mask's noise fill
    (scaled by the global draw's range) and the dB pseudo-phase."""
    t = SpectralTransform(SpectralConfig(**DB), "cpu")
    audio = torch.from_numpy((0.1 * rng.standard_normal((4, DB["segment_length"])))
                             .astype(np.float32))

    def run(x, rows=None):
        g = torch.Generator().manual_seed(3)
        spec, pha, norm = t.to_spectro(x, mask=True, generator=g, rows=rows)
        if draw == "noise_fill":
            return spec
        return t.to_audio(spec, norm, pha, generator=torch.Generator().manual_seed(4),
                          rows=rows)

    whole = run(audio)
    parts = torch.cat([run(audio[:1], (0, 4)), run(audio[1:], (1, 4))])
    assert torch.equal(parts, whole)
    assert not torch.equal(run(audio[1:]), whole[1:])  # drawn locally, they differ


def test_serve_segments_replicas_draw_the_phase_of_one_device(rng):
    """The dB mode's pseudo-phase through ``serve_segments`` over two CPU
    replicas: each draws its own generator at the batch's shape and keeps
    its rows, so the SR equals one device's."""
    opt = dict(OPT, arcsinh_transform=False, abs_norm=False, abs_spectro=False,
               fit_residual=False, input_nc=1)
    model = tapi.create_model(opt, device="cpu")
    seg = SERVE_SPECTRAL["segment_length"]
    segments = (0.1 * rng.standard_normal((6, seg))).astype(np.float32)
    phase = generate_cli.phase_generators(model.transform.cfg, 5)
    assert phase is not None
    single = tapi.serve_segments(model, segments, 4, phase)
    replicas = tapi.replicate(model, mesh.make_mesh(["cpu", "cpu"]))
    np.testing.assert_allclose(tapi.serve_segments(replicas, segments, 4, phase), single,
                               atol=1e-6 * float(np.abs(single).max()))


# --------------------------------------------------------------------------
# the input pipeline's rows and the pool
# --------------------------------------------------------------------------

def _wavs(root, rates):
    r = np.random.default_rng(5)
    root.mkdir(parents=True, exist_ok=True)
    names = []
    for i, rate in enumerate(rates):
        tnative.write_wav16(str(root / f"w{i}.wav"),
                            (0.3 * r.standard_normal(12000)).astype(np.float32), rate)
        names.append(f"w{i}.wav")
    (root / "train.csv").write_text("\n".join(names) + "\n")
    return root / "train.csv"


def _fake_ranks(rank, world, local_world):
    """Where a rank stands, without a group: enough for the pipeline's rows."""
    return mesh.Ranks(rank, world, rank % local_world, local_world, torch.device("cpu"))


def test_input_pipeline_keeps_this_ranks_rows(tmp_path):
    """Every rank of a host reads the host batch from the same seeded
    stream and keeps its rows; a batch the host's ranks do not divide
    raises."""
    csv = _wavs(tmp_path / "c", [48000] * 5)
    cfg = SpectralConfig(**dict(SERVE_SPECTRAL, segment_length=2048))

    def batches(ranks):
        p = InputPipeline(AudioDataset(str(csv), 2048, seed=3), cfg, 4, seed=3,
                          device="cpu", n_threads=1, ranks=ranks)
        try:
            return [next(p) for _ in range(2)]
        finally:
            p.close()

    whole = batches(None)
    for r in range(2):
        got = batches(_fake_ranks(r, 2, 2))
        for g, w in zip(got, whole):
            for k in w:
                assert torch.equal(g[k], w[k][2 * r:2 * r + 2]), k
    p = InputPipeline(AudioDataset(str(csv), 2048), cfg, 3, device="cpu", n_threads=1,
                      ranks=_fake_ranks(0, 2, 2))
    try:
        with pytest.raises(ValueError, match="not divisible"):
            next(p)
    finally:
        p.close()


def test_input_pipeline_ranks_read_one_stream_at_several_threads(tmp_path):
    """With ranks the decode threads keep ``n_threads`` and the stream its
    order: two hosts' ranks given one corpus and one seed read the same
    batches at 3 threads."""
    csv = _wavs(tmp_path / "c", [48000] * 5)
    cfg = SpectralConfig(**dict(SERVE_SPECTRAL, segment_length=2048))
    got = []
    for r in range(2):
        p = InputPipeline(AudioDataset(str(csv), 2048, seed=3), cfg, 4, seed=3,
                          device="cpu", n_threads=3, ranks=_fake_ranks(r, 2, 1))
        try:
            assert len(p._prefetcher._parts) == 3  # --nThreads kept
            got.append([next(p) for _ in range(3)])
        finally:
            p.close()
    for a, b in zip(*got):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_input_pipeline_refuses_mixed_rates_across_hosts(tmp_path):
    """With several hosts, a batch at another rate than the probed one
    raises, as in the JAX package; one host handles it."""
    csv = _wavs(tmp_path / "m", [48000, 44100, 48000, 44100])
    cfg = SpectralConfig(**dict(SERVE_SPECTRAL, segment_length=2048))
    for ranks, fails in ((_fake_ranks(0, 2, 2), False), (_fake_ranks(0, 2, 1), True)):
        p = InputPipeline(AudioDataset(str(csv), 2048, seed=0, serial=True), cfg, 2,
                          device="cpu", n_threads=1, ranks=ranks)
        try:
            if fails:
                with pytest.raises(ValueError, match="multi-host"):
                    next(p)
            else:
                assert next(p)["hr_audio"].shape == (1, 2048)
        finally:
            p.close()


def test_pool_commits_the_kept_rows():
    """``commit(keep=...)`` commits the rows a data-parallel tail keeps;
    the prefix form is the same where they are the first rows."""
    a, b = ImagePool(4, seed=0), ImagePool(4, seed=0)
    fakes = np.arange(4, dtype=np.float32).reshape(4, 1)
    for p in (a, b):
        p.presample((4, 1))
    a.commit(fakes[:2])
    b.commit(fakes, keep=np.array([True, True, False, False]))
    assert [x.tolist() for x in a.images] == [x.tolist() for x in b.images] == [[0.0], [1.0]]
    c = ImagePool(4, seed=0)
    c.presample((4, 1))
    c.commit(fakes, keep=np.array([True, False, True, False]))
    assert [x.tolist() for x in c.images] == [[0.0], [2.0]]


# --------------------------------------------------------------------------
# the train CLI: two --multihost ranks against one process
# --------------------------------------------------------------------------

def test_jax_datasets_with_one_seed_draw_the_same_files(tmp_path):
    """The reading the port's multihost data follows: the JAX package's
    hosts, each with its own ``AudioDataset`` of one corpus and one
    ``--seed``, draw the same crops."""
    csv = _wavs(tmp_path / "j", [48000] * 4)
    a, b = (JAudioDataset(str(csv), 2048, seed=7) for _ in range(2))
    for _ in range(3):
        (xa, ra), (xb, rb) = a.sample_batch_rates(2), b.sample_batch_rates(2)
        assert np.array_equal(xa, xb) and np.array_equal(ra, rb)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One corpus (3 train files: 2 steps of batch 2, the second a padded
    tail; 2 eval files); the train CLI as two ``--multihost`` ranks over
    gloo (rank 1 with a checkpoint directory of its own, to see what it
    writes) and as one process."""
    root = tmp_path_factory.mktemp("dp_cli")
    rng = np.random.default_rng(9)
    (root / "wav").mkdir()
    names = []
    for i, n in enumerate((16000, 17500, 19000, 20500, 22000)):
        t = np.arange(n) / 48000
        x = sum(0.1 / k * np.sin(2 * np.pi * 170 * k * t + i) for k in range(1, 8))
        tnative.write_wav16(str(root / "wav" / f"s{i}.wav"),
                            (x + 0.01 * rng.standard_normal(n)).astype(np.float32), 48000)
        names.append(f"wav/s{i}.wav")
    (root / "train.csv").write_text("\n".join(names[:3]) + "\n")
    (root / "eval.csv").write_text("\n".join(names[3:]) + "\n")
    run = GEOMETRY + [
        "--dataroot", str(root / "train.csv"), "--evalroot", str(root / "eval.csv"),
        "--niter", "1", "--niter_decay", "0", "--print_freq", "2", "--eval_freq", "4",
        "--eval_size", "2", "--save_latest_freq", "1000", "--save_epoch_freq", "1",
        "--display_freq", "1000000", "--nThreads", "1", "--no_html", "--name", "run"]
    procs, logs = _multihost_ranks(root, run)
    outs = [_finish(p, log) for p, log in zip(procs, logs)]
    ranks = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    one = train_cli.main(run + ["--gpu_ids", "-1", "--checkpoints_dir", str(root / "one")])
    return dict(root=root, run=run, ranks=ranks, one=one)


def _multihost_ranks(root, run, tag="rank"):
    """Two ``--multihost`` ranks of the train CLI over gloo on the CPU
    (torchrun's variables, one rank a host), each writing to a log and to
    a checkpoint directory of its own; the processes and their logs."""
    env = dict(os.environ, WORLD_SIZE="2", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(mesh.free_port()))
    procs, logs = [], []
    for r in range(2):
        logs.append(root / f"{tag}{r}.log")
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "_torch_parallel_worker.py"), *run,
                 "--multihost", "--gpu_ids", "-1", "--checkpoints_dir", str(root / f"{tag}{r}")],
                env=dict(env, RANK=str(r)), stdout=log, stderr=subprocess.STDOUT))
    return procs, logs


def _finish(proc, log):
    """The rank's output once it exits 0 within the deadline (killed and
    failed otherwise)."""
    try:
        rc = proc.wait(timeout=SPAWN_DEADLINE_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    out = log.read_text(errors="replace")
    assert rc == 0, out[-3000:]
    return out


def test_multihost_ranks_hold_one_state(cli_runs):
    """Both ranks hold the same state after the run, bit for bit."""
    a, b = cli_runs["ranks"]
    assert a["digest"] == b["digest"]
    assert len(a["agree_ms"]) == len(b["agree_ms"]) == 2


def test_multihost_rank_0_alone_writes(cli_runs):
    """Rank 0 writes ``opt.txt``, the log, ``eval.csv`` and the save (its
    epoch index included); rank 1 writes no file and evaluates nothing."""
    root = cli_runs["root"]
    run0 = root / "rank0" / "run"
    for name in ("opt.txt", "loss_log.txt", "eval.csv", "ckpt/epoch_index.json",
                 "ckpt/step_2.pt"):
        assert (run0 / name).is_file(), name
    assert [p for p in (root / "rank1").rglob("*") if p.is_file()] == []
    a, b = cli_runs["ranks"]
    assert (a["writes"], a["evals"], b["writes"], b["evals"]) == (1, 1, 0, 0)
    assert a["saves"] == b["saves"] == 1


def test_multihost_ranks_step_as_one_process(cli_runs):
    """Both hosts read the same rows (one corpus, one ``--seed``), so the
    global batch holds every row twice and the run's losses are one
    process's at the same ``--batchSize``, to float32 reduction order."""
    got, ref = cli_runs["ranks"][0]["losses"], cli_runs["one"]["losses"]
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [1, 2]
    for g, r in zip(got, ref):
        for k in ("G_GAN", "G_GAN_Feat", "D_real", "D_fake", "loss_G", "loss_D"):
            np.testing.assert_allclose(g[k], r[k], rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                       err_msg=f"step {r['step']} {k}")


def test_gpu_ids_spawns_one_rank_a_device(cli_runs, monkeypatch):
    """``--gpu_ids a,b`` starts one rank a device (``mesh.spawn``; here two
    CPU devices stand in for the cards): the ranks split one batch of 2,
    hold one state, and the run's losses are one process's at the same
    ``--batchSize``, to float32 reduction order."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(train_cli, "serving_devices", lambda opt: [cpu, cpu])
    root = cli_runs["root"]
    got = train_cli.main(cli_runs["run"] + ["--gpu_ids", "0,1", "--checkpoints_dir",
                                            str(root / "spawned")])
    a, b = got["ranks"]
    assert a["digest"] == b["digest"]
    assert (root / "spawned" / "run" / "ckpt" / "step_2.pt").is_file()
    for g, r in zip(got["losses"], cli_runs["one"]["losses"]):
        for k in ("G_GAN", "G_GAN_Feat", "D_real", "D_fake", "loss_G", "loss_D"):
            np.testing.assert_allclose(g[k], r[k], rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)


def test_gpu_ids_without_those_cards_raise(tmp_path, monkeypatch):
    """``--gpu_ids 0,1`` on a host with one card raises before any rank
    starts, in both CLIs; the JAX CLIs would clamp to one device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(mesh, "spawn", lambda *a, **k: pytest.fail("spawned"))
    args = GEOMETRY + ["--checkpoints_dir", str(tmp_path), "--name", "x", "--gpu_ids", "0,1"]
    for cli in (train_cli, generate_cli):
        with pytest.raises(ValueError, match="1 CUDA device"):
            cli.main(args)


def test_multihost_ranks_stop_together_on_a_signal(cli_runs):
    """SIGTERM to rank 1 alone: the ranks agree on it at the end of the
    step, so both stop after the same step, rank 0 saves it, and both exit
    0."""
    root = cli_runs["root"]
    run = cli_runs["run"] + ["--niter", "500", "--eval_freq", "1000000"]
    procs, logs = _multihost_ranks(root, run, tag="term")
    try:
        deadline = time.time() + SPAWN_DEADLINE_S
        while time.time() < deadline and procs[1].poll() is None:
            if "End of epoch 1" in logs[1].read_text(errors="replace"):
                break
            time.sleep(0.2)
        assert procs[1].poll() is None, logs[1].read_text(errors="replace")[-3000:]
        procs[1].send_signal(signal.SIGTERM)
    finally:
        outs = [_finish(p, log) for p, log in zip(procs, logs)]
    a, b = (json.loads(out.strip().splitlines()[-1]) for out in outs)
    assert "SIGTERM received" in outs[1] and "SIGTERM received" not in outs[0]
    assert a["interrupted"] and b["interrupted"]
    assert len(a["agree_ms"]) == len(b["agree_ms"]) >= 2
    assert a["digest"] == b["digest"]
    steps = [int(p.stem.split("_")[1]) for p in (root / "term0" / "run" / "ckpt").glob("step_*.pt")]
    assert max(steps) == len(a["agree_ms"])
    assert [p for p in (root / "term1").rglob("*") if p.is_file()] == []
