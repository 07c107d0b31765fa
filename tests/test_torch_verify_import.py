"""The port's checkpoint verifier (``mdctgan_tpu_torch/verify_import_cli.py``)
against the JAX tool (``tools/verify_import.py``), on the CPU at the tiny
geometry of ``tests/test_export_torch.py::test_verify_import_cli``.

Both tools read the same ``.pth`` files, written by the JAX package's
exporter from a seeded JAX train state, with the same flags.  Their
reports must be the same lines and their exit codes the same; their
forward passes (``--forward --gpu_ids -1``) must give the same output
within 1e-5 relative.  Nothing in ``mdctgan_tpu/`` or ``tools/`` changes.
"""

import hashlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from mdctgan_tpu_torch import verify_import_cli

ROOT = Path(__file__).resolve().parents[1]
_BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "mdctgan_tpu")
FLAGS = [
    "--netG", "local", "--ngf", "4", "--n_downsample_global", "2",
    "--n_blocks_global", "2", "--n_blocks_attn_g", "1",
    "--heads_g", "2", "--dim_head_g", "4", "--n_blocks_local", "2",
    "--num_D", "2", "--n_layers_D", "2", "--ndf", "4",
    "--n_fft", "128", "--hop_length", "64", "--win_length", "128",
    "--bins", "128", "--segment_length", "8128", "--center",
    "--upsample_type", "interpolate", "--downsample_type", "resconv",
]


def _with(flags, flag, value):
    out = list(flags)
    out[out.index(flag) + 1] = value
    return out


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "verify_import", ROOT / "tools" / "verify_import.py")
    vi = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vi)
    return vi


@pytest.fixture(scope="module")
def pth_dir(tmp_path_factory):
    """``latest_net_G.pth`` and ``latest_net_D.pth`` of a seeded JAX state at
    the tiny geometry, as the JAX test writes them; and a copy of G whose
    first downsampling stage (``model.4``) is renamed ``model.40``, for
    ``--param_key_map model.40:4``."""
    import torch

    from mdctgan_tpu.export_torch_cli import export_state_to_pth
    from mdctgan_tpu.models.discriminator import build_discriminator
    from mdctgan_tpu.models.generator import build_generator
    from mdctgan_tpu.options import TrainOptions, spectral_config_from_opt
    from mdctgan_tpu.train.schedule import make_optimizers
    from mdctgan_tpu.train.state import create_train_state

    out = tmp_path_factory.mktemp("pth")
    opt = TrainOptions().parse(FLAGS + ["--checkpoints_dir", str(out / "ck")], save=False)
    cfg = spectral_config_from_opt(opt)
    gen = build_generator(opt)
    g_tx, d_tx = make_optimizers(2e-4, 0.5, 1, 0, 1)
    state = create_train_state(
        jax.random.PRNGKey(0), gen, build_discriminator(opt), g_tx, d_tx,
        spectro_shape=(cfg.n_bins, cfg.n_fft // 2), g_in_channels=opt.input_nc,
        d_in_channels=opt.input_nc + opt.output_nc)
    export_state_to_pth(state, gen, opt, str(out), "latest")
    sd = torch.load(out / "latest_net_G.pth", weights_only=True)
    torch.save({"model.40." + k[len("model.4."):] if k.startswith("model.4.") else k: v
                for k, v in sd.items()}, out / "renamed_net_G.pth")
    return out


CASES = {
    "G": ("latest_net_G.pth", FLAGS),
    "D": ("latest_net_D.pth", FLAGS),
    "wrong_n_blocks_global": ("latest_net_G.pth", _with(FLAGS, "--n_blocks_global", "3")),
    "wrong_n_layers_D": ("latest_net_D.pth", _with(FLAGS, "--n_layers_D", "3")),
    "param_key_map": ("renamed_net_G.pth",
                      FLAGS + ["--param_key_map", "model.40:4"]),
}


def _report(out: str) -> list:
    """The tool's lines after the options' dump (whose temporary directory
    and keys differ between the packages)."""
    lines = out.splitlines()
    return lines[lines.index("-------------- End ----------------") + 1:]


@pytest.mark.parametrize("case", sorted(CASES))
def test_report_matches_jax_tool(case, jax_tool, pth_dir, capsys):
    """The same report, line for line, and the same exit code: a strict OK
    for G and D (0), the missing keys with their size-matched candidates
    for a wrong ``--n_blocks_global`` (1), the missing keys and shape
    mismatches of a wrong ``--n_layers_D`` (1), and the renames applied by
    ``--param_key_map`` (0)."""
    name, flags = CASES[case]
    argv = [str(pth_dir / name)] + flags
    rc_jax = jax_tool.main(argv)
    ref = _report(capsys.readouterr().out)
    rc = verify_import_cli.main(argv)
    got = _report(capsys.readouterr().out)
    assert got == ref
    assert rc == rc_jax == (1 if case.startswith("wrong") else 0)
    text = "\n".join(got)
    if case == "wrong_n_blocks_global":
        assert "MISSING" in text and "size-matched candidates" in text
    elif case == "wrong_n_layers_D":
        assert "MISSING" in text and "SHAPE MISMATCH" in text
    elif case == "param_key_map":
        assert "via --param_key_map" in text and "100% matched" in text
    else:
        assert "100% matched" in text and "[verify] net kind inferred from filename" in text


class _Recording:
    """``numpy`` for the JAX tool, recording the arrays its forward pass
    hands to ``np.asarray(y, np.float32)``."""

    def __init__(self):
        self.outputs = []

    def __getattr__(self, name):
        return getattr(np, name)

    def asarray(self, a, *args, **kwargs):
        out = np.asarray(a, *args, **kwargs)
        if args[:1] == (np.float32,):
            self.outputs.append(out)
        return out


@pytest.mark.parametrize("net", ["G", "D"])
def test_forward_matches_jax_tool(net, jax_tool, pth_dir, capsys, monkeypatch):
    """``--forward --gpu_ids -1``: the port's output (NHWC) equals the JAX
    tool's within 1e-5 of its largest value, the printed shape is the
    same, each checksum is that of its own output rounded to 1e-4, and
    where no value lies within the two outputs' distance of a rounding
    boundary the checksums are equal."""
    argv = [str(pth_dir / f"latest_net_{net}.pth"), "--forward", "--gpu_ids", "-1"] + FLAGS
    rec = _Recording()
    monkeypatch.setattr(jax_tool, "np", rec)
    assert jax_tool.main(argv) == 0
    ref_lines = _report(capsys.readouterr().out)
    (ref,) = rec.outputs
    got = verify_import_cli.verify(argv)
    lines = _report(capsys.readouterr().out)
    assert got.ok and got.output.shape == ref.shape
    err = float(np.abs(got.output - ref).max())
    assert err <= 1e-5 * float(np.abs(ref).max()), err
    assert lines[:-1] == ref_lines[:-1]

    def digest(a):
        return hashlib.sha256(np.round(a.astype(np.float64), 4).tobytes()).hexdigest()[:16]

    assert lines[-1].endswith(digest(got.output)) and ref_lines[-1].endswith(digest(ref))
    assert lines[-1].split(": out shape ")[1].split(",")[0:4] == \
        ref_lines[-1].split(": out shape ")[1].split(",")[0:4]
    frac = np.abs(ref.astype(np.float64) * 1e4 % 1.0 - 0.5)
    if float(frac.min()) > 1e4 * err:  # no value near a rounding boundary
        assert digest(got.output) == digest(ref)


def test_verifier_leaves_jax_unimported(pth_dir):
    """The module entry point in a fresh interpreter, with ``--forward`` on
    the CPU: exit 0, and no JAX, Flax, optax, orbax or reference module
    imported."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['verify_import_cli', {str(pth_dir / 'latest_net_G.pth')!r}, '--forward',\n"
        f"            '--gpu_ids', '-1'] + {FLAGS!r}\n"
        "try:\n"
        "    runpy.run_module('mdctgan_tpu_torch.verify_import_cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{_BANNED!r})\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "strict load: OK" in proc.stdout


def test_forward_without_cuda_raises(pth_dir):
    """``--forward`` follows the generate CLI's device rule: the default
    ``--gpu_ids 0`` raises without CUDA; the report alone needs no device."""
    argv = [str(pth_dir / "latest_net_G.pth")] + FLAGS
    assert verify_import_cli.main(argv) == 0
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            verify_import_cli.main(argv + ["--forward"])
