"""The port's export CLI (``mdctgan_tpu_torch/export_torch_cli.py``) against
the JAX package's on the CPU: from a checkpoint of the port's train state
it writes the reference-layout ``.pth`` files that the JAX exporter writes
for the same weights (the same keys, shapes and values), the JAX importer
and the port's ``generate_cli`` read them back, and a save that lacks a
parameter of the model fails.

Sizes: the ``netG global`` geometry of ``test_torch_generate.py`` (ngf 4,
two downsamples, one resblock and one attention block) and a 2-scale
discriminator of ndf 4 and 2 layers.
"""

import types

import jax
import numpy as np
import pytest
import torch

from mdctgan_tpu import export_torch_cli as jexport
from mdctgan_tpu.models.discriminator import MultiscaleDiscriminator as JMultiscaleDiscriminator
from mdctgan_tpu.models.generator import build_generator as j_build_generator
from mdctgan_tpu.train import import_torch as jimp

from mdctgan_tpu_torch import export_torch_cli, generate_cli
from mdctgan_tpu_torch.data import native as tnative
from mdctgan_tpu_torch.models.discriminator import build_discriminator
from mdctgan_tpu_torch.models.generator import build_generator
from mdctgan_tpu_torch.options import TrainOptions
from mdctgan_tpu_torch.train.checkpoint import CheckpointManager
from mdctgan_tpu_torch.train.schedule import OptimizerSpec
from mdctgan_tpu_torch.train.state import create_train_state
from mdctgan_tpu_torch.weights import state_dict_from_jax

from test_torch_generate import FLAGS, _jax_opt
from test_torch_models import _flax_vars

D_FLAGS = ["--num_D", "2", "--n_layers_D", "2", "--ndf", "4"]
SGD = OptimizerSpec(lambda p: torch.optim.SGD(p, lr=1.0))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A run directory holding a port checkpoint of seeded Flax weights,
    saved at steps 3 (epoch 1's end) and 5, and the JAX exporter's files
    for the same weights."""
    root = tmp_path_factory.mktemp("export")
    jopt = _jax_opt(root / "unused", D_FLAGS)
    flax_g, flax_d = j_build_generator(jopt), JMultiscaleDiscriminator(ndf=4, n_layers=2, num_D=2)
    rng = np.random.default_rng(8)
    g_params, g_stats = _flax_vars(flax_g, np.zeros((1, 2, 128, 64), np.float32), rng,
                                   train=False)
    g_params["head"]["conv"] = {k: v * 0.01 for k, v in g_params["head"]["conv"].items()}
    d_params, _ = _flax_vars(flax_d, np.zeros((1, 3, 128, 64), np.float32), rng)
    jexport.export_state_to_pth(
        types.SimpleNamespace(g_params=g_params, batch_stats=g_stats, d_params=d_params),
        flax_g, jopt, str(root / "jax"), "latest")

    opt = TrainOptions().parse(FLAGS + D_FLAGS + ["--checkpoints_dir", str(root / "unused")],
                               save=False)
    gen, disc = build_generator(opt), build_discriminator(opt)
    gen.load_state_dict(state_dict_from_jax(g_params, g_stats), strict=True)
    disc.load_state_dict(state_dict_from_jax(d_params, {}), strict=True)
    state = create_train_state(gen, disc, SGD, SGD, device="cpu")
    mgr = CheckpointManager(str(root / "run" / "ckpt"))
    for step, label in ((3, 1), (5, None)):
        state.step = step
        mgr.save(state, epoch=2, epoch_label=label)
    mgr.close()
    return dict(root=root, flax_g=flax_g, g_params=g_params, g_stats=g_stats,
                d_params=d_params)


def _export(run, out, *extra):
    return export_torch_cli.main(FLAGS + D_FLAGS + [
        "--checkpoints_dir", str(run["root"] / "unused"), "--load_pretrain",
        str(run["root"] / "run"), "--export_dir", str(out), *extra])


def test_export_equals_the_jax_export(run, tmp_path):
    """The same files, keys, shapes, dtypes and values, bit for bit."""
    paths = _export(run, tmp_path)
    assert [p.rsplit("/", 1)[1] for p in paths] == ["latest_net_G.pth", "latest_net_D.pth"]
    for name in ("latest_net_G.pth", "latest_net_D.pth"):
        got = torch.load(tmp_path / name, map_location="cpu", weights_only=True)
        ref = torch.load(run["root"] / "jax" / name, map_location="cpu", weights_only=True)
        assert list(got) == list(ref), name
        for k in ref:
            assert got[k].dtype == ref[k].dtype == torch.float32 and got[k].is_contiguous()
            assert torch.equal(got[k], ref[k]), (name, k)


def test_export_reads_the_jax_importer(run, tmp_path):
    """The JAX importer loads the port's files strictly and gives back the
    Flax trees the weights came from."""
    _export(run, tmp_path)
    params, stats = jimp.import_generator(jimp.load_pth(str(tmp_path / "latest_net_G.pth")),
                                          run["flax_g"])
    for tree, ref in ((params, run["g_params"]), (stats, run["g_stats"])):
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    d_params = jimp.import_discriminator(jimp.load_pth(str(tmp_path / "latest_net_D.pth")), 2, 2)
    for a, b in zip(jax.tree.leaves(d_params), jax.tree.leaves(run["d_params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_generate_serves_the_export_as_the_checkpoint(run, tmp_path):
    """``generate_cli --load_pretrain`` on the exported files and on the run's
    ``ckpt/``: the same SR waveform, bit for bit, the files loaded with no
    fallback rung."""
    _export(run, tmp_path / "exported")
    wav = tmp_path / "in.wav"
    t = np.arange(12000) / 48000
    tnative.write_wav16(str(wav), (0.1 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 48000)
    out = {}
    for name, src in (("pth", tmp_path / "exported"), ("ckpt", run["root"] / "run")):
        r = generate_cli.main(FLAGS + ["--checkpoints_dir", str(tmp_path), "--name", name,
                                       "--dataroot", str(wav), "--load_pretrain", str(src)])
        assert r["rungs"] == []
        out[name] = (tmp_path / name / "sr_audio.wav").read_bytes()
    assert out["pth"] == out["ckpt"]


def test_export_step_and_epoch(run, tmp_path):
    """``--which_epoch 1`` resolves through the epoch index and names the
    files; ``--export_step`` picks a save directly and keeps the label."""
    _export(run, tmp_path / "e1", "--which_epoch", "1")
    assert sorted(p.name for p in (tmp_path / "e1").iterdir()) == ["1_net_D.pth", "1_net_G.pth"]
    _export(run, tmp_path / "s3", "--export_step", "3")
    a = torch.load(tmp_path / "e1" / "1_net_G.pth", weights_only=True)
    b = torch.load(tmp_path / "s3" / "latest_net_G.pth", weights_only=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(FileNotFoundError, match="available epochs"):
        _export(run, tmp_path / "e9", "--which_epoch", "9")


def test_export_fails_fast_on_a_missing_key(run, tmp_path):
    """A save without one of the model's parameters, or a model built with
    other architecture flags, raises with the names; nothing is written."""
    ckpt = tmp_path / "run" / "ckpt"
    ckpt.mkdir(parents=True)
    payload = torch.load(run["root"] / "run" / "ckpt" / "step_5.pt", weights_only=True)
    del payload["state"]["generator"]["res0.conv1.conv.weight"]
    torch.save(payload, ckpt / "step_5.pt")
    args = FLAGS + D_FLAGS + ["--checkpoints_dir", str(tmp_path), "--export_dir",
                              str(tmp_path / "out")]
    with pytest.raises(ValueError, match=r"res0\.conv1\.conv\.weight \(missing\)"):
        export_torch_cli.main(args + ["--load_pretrain", str(tmp_path / "run")])
    with pytest.raises(ValueError, match=r"res1\..*\(missing\)"):
        export_torch_cli.main(args + ["--load_pretrain", str(run["root"] / "run"),
                                      "--n_blocks_global", "2"])
    assert not (tmp_path / "out").exists()
    with pytest.raises(SystemExit, match="load_pretrain"):
        export_torch_cli.main(args)
