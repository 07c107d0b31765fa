"""The port's serving export (``mdctgan_tpu_torch/export_cli.py``,
``serve_export.py``) and the registered operators K1 and K2
(``ops/mdct_kernels.py``) on the CPU.

The same reference-layout ``.pth`` of seeded Flax weights goes through the
JAX package's ``export_inference`` (``--export_platforms cpu``, deserialized
and called) and the port's ``export_cli.main`` (``--gpu_ids -1``, loaded by
``serve_export.load``), on the same seeded LR segments: the program agrees
with JAX's within 2e-3 of the waveform's largest value, the bound of
``tests/test_torch_serve.py``, and with the port's own ``build_inference_fn``
bit for bit, in float32 and with ``--fp16``; it reloads in a fresh process
that imports no model code; its graph holds K1 and K2 as operator nodes
where the configuration runs them; another batch raises; the platform
flag's rules hold; the ``--export_platforms tpu,cpu`` program, loaded on
the CPU, agrees with the JAX package's ``tpu,cpu`` artifact and equals
the ``cpu`` program, and ``serve_export.load`` places it only on a
platform it records; and both operators pass ``torch.library.opcheck``.

Sizes: ``netG local`` (the flagship's layout, whose coarse branch is named
``global``) at the geometry of ``tests/test_torch_serve.py`` (n_fft 128,
8128-sample segments, ngf 4, two downsamples, one resblock each side and
one attention block), batch 2; and the generate CLI's default spectral
flags (dB, per-sample bounds, no centring: the matmul form) at the segment
that gives the generator 128 frames.  Each export happens once per module
(fixture).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mdctgan_tpu import export_cli as jexport
from mdctgan_tpu.models.generator import build_generator as j_build_generator
from mdctgan_tpu.options import TrainOptions as JTrainOptions
from mdctgan_tpu.train import import_torch as jimp

from mdctgan_tpu_torch import export_cli, serve_export
from mdctgan_tpu_torch.models.generator import build_generator
from mdctgan_tpu_torch.ops import mdct_kernels as K
from mdctgan_tpu_torch.ops.features import SpectralTransform
from mdctgan_tpu_torch.options import TrainOptions, spectral_config_from_opt
from mdctgan_tpu_torch.train.step import build_inference_fn
from mdctgan_tpu_torch.weights import state_dict_from_jax

from test_torch_models import _flax_vars
from test_torch_serve import _BANNED

ROOT = Path(__file__).resolve().parents[1]
BATCH = 2
MODEL = [
    "--lr_sampling_rate", "16000", "--norm_range", "-1", "1", "--fit_residual",
    "--netG", "local", "--ngf", "4", "--n_downsample_global", "2",
    "--n_blocks_global", "1", "--n_blocks_local", "1", "--n_blocks_attn_g", "1",
    "--heads_g", "2", "--dim_head_g", "4", "--n_fft", "128", "--hop_length", "64",
    "--win_length", "128", "--bins", "128", "--jax_cache_dir", "",
    "--export_batch", str(BATCH),
]
CONFIGS = {
    # the flagship's spectral flags: K1 and K2
    "fused": MODEL + ["--center", "--arcsinh_transform", "--abs_spectro", "--abs_norm",
                      "--segment_length", "8128"],
    # the generate CLI's defaults: dB, per-sample bounds, no centring (127
    # hops + n_fft samples make 128 frames): the matmul form
    "matmul_form": MODEL + ["--input_nc", "1", "--segment_length", "8256"],
}
K1_NODE, K2_NODE = torch.ops.mdctgan.mdct_spectro.default, torch.ops.mdctgan.imdct_audio.default


def _args(case, flags_only=False, platforms="cpu"):
    args = CONFIGS[case["config"]] + ["--checkpoints_dir", str(case["root"] / "unused")]
    return args if flags_only else args + ["--load_pretrain", str(case["pretrain"]),
                                           "--export_platforms", platforms]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """For each configuration: seeded Flax weights as a reference ``.pth``,
    seeded LR segments, the SR of them by the JAX exports for ``cpu`` and
    for ``tpu,cpu``, and the port's programs (float32, ``--fp16``, and
    float32 for ``tpu,cpu``) with what ``main`` returned."""
    root = tmp_path_factory.mktemp("export_cli")
    rng = np.random.default_rng(21)
    out = {}
    for config in CONFIGS:
        case = {"config": config, "root": root, "pretrain": root / config}
        jopt = JTrainOptions().parse(_args(case, flags_only=True), save=False)
        flax_g = j_build_generator(jopt)
        params, stats = _flax_vars(flax_g, np.zeros((1, jopt.input_nc, 128, 64), np.float32),
                                   rng, train=False)
        # a damped head keeps the SR band small, as a trained model's is
        params["local_head"]["conv"] = {k: v * 0.01
                                        for k, v in params["local_head"]["conv"].items()}
        case["pretrain"].mkdir()
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in
                    jimp.export_to_torch_keys(params, stats,
                                              jimp.generator_entries_for(flax_g)).items()},
                   case["pretrain"] / "latest_net_G.pth")
        lr = (0.05 * rng.standard_normal((BATCH, jopt.segment_length))).astype(np.float32)
        case.update(state=state_dict_from_jax(params, stats), lr=lr)
        for label, platforms in (("jax_sr", "cpu"), ("jax_multi_sr", "tpu,cpu")):
            blob = jexport.export_inference(JTrainOptions().parse(
                _args(case, platforms=platforms), save=False))
            case[label] = np.asarray(jax.export.deserialize(blob).call(jnp.asarray(lr)))
        for label, extra in (("f32", []), ("fp16", ["--fp16"]),
                             ("multi", ["--export_platforms", "tpu,cpu"])):
            path = root / f"{config}_{label}.pt2"
            case[label] = export_cli.main(_args(case) + extra + [
                "--gpu_ids", "-1", "--export_path", str(path)])
        out[config] = case
    return out


def _port_inference(case, fp16=False):
    """The port's ``build_inference_fn`` on the case's weights, CPU."""
    opt = TrainOptions().parse(_args(case) + (["--fp16"] if fp16 else []), save=False)
    gen = build_generator(opt)
    gen.load_state_dict(case["state"], strict=True)
    return build_inference_fn(gen.eval(), SpectralTransform(spectral_config_from_opt(opt), "cpu"),
                              out_length=opt.segment_length)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_cpu_program_matches_the_jax_export(exported, config):
    case = exported[config]
    assert case["f32"]["device"] == "cpu" and case["f32"]["bytes"] > 10_000
    got = serve_export.load(case["f32"]["path"])(torch.from_numpy(case["lr"])).numpy()
    ref = case["jax_sr"]
    assert got.shape == ref.shape == case["lr"].shape
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, atol=2e-3 * scale)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_multi_platform_program_matches_the_jax_export(exported, config):
    """``--export_platforms tpu,cpu``: the JAX package's artifact for both
    platforms, called on the CPU, against the port's program for both,
    loaded on the CPU."""
    case = exported[config]
    assert case["multi"]["platforms"] == ["tpu", "cpu"] and case["multi"]["device"] == "cpu"
    got = serve_export.load(case["multi"]["path"], device="cpu")(
        torch.from_numpy(case["lr"])).numpy()
    ref = case["jax_multi_sr"]
    assert got.shape == ref.shape == case["lr"].shape
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, atol=2e-3 * scale)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_multi_platform_program_equals_the_cpu_program(exported, config):
    """One graph and one copy of the weights whatever the list: the
    ``tpu,cpu`` program on the CPU is the ``cpu`` program bit for bit, and
    its file holds the weights once."""
    case = exported[config]
    x = torch.from_numpy(case["lr"])
    got = serve_export.load(case["multi"]["path"], device="cpu")(x)
    torch.testing.assert_close(got, serve_export.load(case["f32"]["path"])(x), rtol=0, atol=0)
    assert abs(case["multi"]["bytes"] - case["f32"]["bytes"]) < 0.01 * case["f32"]["bytes"]


def test_load_places_and_refuses_by_platform(exported, monkeypatch, tmp_path):
    """The recorded platforms decide where ``load`` may place a program:
    by default the first (the card, which this host lacks); a device the
    program does not name raises ``ValueError``; a program written without
    a record runs on the device of its weights, as before the record."""
    case = exported["fused"]
    multi, single = case["multi"]["path"], case["f32"]["path"]
    assert serve_export.platforms_of(multi) == ["tpu", "cpu"]
    assert serve_export.platforms_of(single) == ["cpu"]
    x = torch.from_numpy(case["lr"])
    ref = serve_export.load(single)(x)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_export.load(multi, device=device)
    with pytest.raises(ValueError, match="unsupported"):
        serve_export.load(multi, device="meta")
    # a host with a card: the CPU program refuses it before any move
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="cpu"):
        serve_export.load(single, device="cuda:0")
    # no record: saved as before this record existed
    bare = tmp_path / "bare.pt2"
    torch.export.save(torch.export.load(single), bare)
    assert serve_export.platforms_of(str(bare)) is None
    with pytest.raises(ValueError, match="is for cpu"):
        serve_export.load(str(bare), device="cuda:0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cpu"):
        torch.testing.assert_close(serve_export.load(str(bare), device=device)(x), ref,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("label", ["f32", "fp16"])
def test_program_equals_the_ports_inference_fn(exported, config, label):
    """The program and ``build_inference_fn`` run one module
    (``InferenceModule``), so they agree bit for bit; under ``--fp16`` the
    program holds the bf16 generator and float32 transforms."""
    case = exported[config]
    x = torch.from_numpy(case["lr"])
    got = serve_export.load(case[label]["path"])(x)
    _, ref = _port_inference(case, fp16=label == "fp16")(x)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("label,device", [("f32", None), ("multi", "cpu")])
def test_program_serves_in_a_fresh_process_with_only_the_ops(exported, tmp_path, label,
                                                             device):
    """The CPU program, and the ``tpu,cpu`` program on the CPU, in a process
    that sees no card and imports no model code; there the ``tpu,cpu``
    program's default device (the card) raises."""
    case = exported["fused"]
    path = case[label]["path"]
    np.save(tmp_path / "lr.npy", case["lr"])
    code = (
        "import sys, numpy as np, torch\n"
        "from mdctgan_tpu_torch.serve_export import load\n"
        f"serve = load({path!r}, device={device!r})\n"
        f"np.save({str(tmp_path / 'sr.npy')!r}, "
        f"serve(torch.from_numpy(np.load({str(tmp_path / 'lr.npy')!r}))).numpy())\n"
        "if " + repr(device is not None) + ":\n"
        "    try:\n"
        f"        load({path!r})\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('the default device served without a card')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{_BANNED!r})\n"
        "assert not bad, bad\n"
        "port = sorted(m for m in sys.modules if m.startswith('mdctgan_tpu_torch'))\n"
        "assert port == ['mdctgan_tpu_torch', 'mdctgan_tpu_torch.device', "
        "'mdctgan_tpu_torch.ops', 'mdctgan_tpu_torch.ops._build', "
        "'mdctgan_tpu_torch.ops.mdct', 'mdctgan_tpu_torch.ops.mdct_kernels', "
        "'mdctgan_tpu_torch.ops.window', 'mdctgan_tpu_torch.serve_export'], port\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    _, ref = _port_inference(case)(torch.from_numpy(case["lr"]))
    np.testing.assert_array_equal(np.load(tmp_path / "sr.npy"), ref.numpy())


@pytest.mark.parametrize("config,count", [("fused", 1), ("matmul_form", 0)])
def test_graph_holds_k1_and_k2_where_the_configuration_runs_them(exported, config, count):
    """A configuration that ``fused_compatible`` accepts: one node of each
    operator, each reading the program's own matrix buffer, which nothing
    else reads.  The matmul form: no operator node; its products read the
    buffers."""
    program = torch.export.load(exported[config]["f32"]["path"])
    nodes = list(program.graph.nodes)
    assert sum(n.target == K1_NODE for n in nodes) == count
    assert sum(n.target == K2_NODE for n in nodes) == count
    inputs = program.graph_signature.inputs_to_buffers
    readers = {buf: {u.target for u in node.users} for node in nodes
               for name, buf in inputs.items() if node.name == name
               and buf in ("spectro_mat", "synth_mat")}
    assert set(readers) == {"spectro_mat", "synth_mat"}
    if count:
        assert readers == {"spectro_mat": {K1_NODE}, "synth_mat": {K2_NODE}}
    else:
        assert all(torch.ops.aten.matmul.default in r for r in readers.values())


def test_program_refuses_another_batch(exported):
    case = exported["fused"]
    serve = serve_export.load(case["f32"]["path"])
    with pytest.raises((AssertionError, RuntimeError)):
        serve(torch.from_numpy(case["lr"][:1]))
    with pytest.raises((AssertionError, RuntimeError)):
        serve(torch.from_numpy(np.concatenate([case["lr"], case["lr"]])))


@pytest.mark.parametrize("platforms,gpu_ids,error", [
    ("cpu", "-1", None),
    ("tpu,cpu", "-1", None),
    ("cuda,cpu", "-1", None),
    ("cpu,gpu", "-1", ValueError),
    ("tpu,", "-1", ValueError),
    ("cuda,cpu", "0", RuntimeError),  # no CUDA
    ("cuda", "-1", ValueError),
    ("tpu", "-1", ValueError),
    ("gpu", "-1", ValueError),
    ("tpu", "0", RuntimeError),  # the defaults, without CUDA
    ("cuda", "0", RuntimeError),
])
def test_platform_and_device_rules(monkeypatch, tmp_path, platforms, gpu_ids, error):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = TrainOptions().parse(CONFIGS["fused"] + [
        "--checkpoints_dir", str(tmp_path), "--export_platforms", platforms,
        "--gpu_ids", gpu_ids], save=False)
    if error is None:
        assert export_cli.export_device(opt) == torch.device("cpu")
    else:
        with pytest.raises(error):
            export_cli.export_device(opt)


def test_default_export_raises_without_cuda(monkeypatch, tmp_path):
    """The CLI itself with its default device and platform: no program is
    written where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "m.pt2"
    with pytest.raises(RuntimeError, match="CUDA"):
        export_cli.main(CONFIGS["fused"] + ["--checkpoints_dir", str(tmp_path),
                                            "--load_pretrain", str(tmp_path),
                                            "--export_path", str(path)])
    assert not path.exists()


@pytest.mark.parametrize("n_fft", [128, 96])  # the FFT form's N, the dense form's
@pytest.mark.parametrize("op", ["mdct_spectro", "imdct_audio"])
def test_opcheck(rng, op, n_fft):
    k = n_fft // 2
    if op == "mdct_spectro":
        args = (torch.from_numpy((0.1 * rng.standard_normal((2, 40 * k))).astype(np.float32)),
                K.spectro_matrix(n_fft), 1000.0, 0.2, 0.0, k, n_fft)
    else:
        args = (torch.from_numpy(rng.uniform(-1, 1, (2, 41, k)).astype(np.float32)),
                K.synth_matrix(n_fft), 1000.0, 5.0, 0.0, k, n_fft)
    opdef = getattr(K, f"{op}_op")
    torch.library.opcheck(opdef, args)
    plain = K.mdct_spectro_plain if op == "mdct_spectro" else K.imdct_audio_plain
    torch.testing.assert_close(opdef(*args), plain(*args[:5]), rtol=0, atol=0)


def test_fake_refuses_what_the_card_refuses():
    """The shape functions check as the kernels do, so an export for the
    card fails when it is made: float64, non-contiguous, another framing,
    a single frame for K2."""
    with FakeTensorMode():
        x = torch.empty(2, 8128, device="cuda")
        mat, syn = torch.empty(128, 64, device="cuda"), torch.empty(64, 128, device="cuda")
        assert K.mdct_spectro_op(x, mat, 1000.0, 0.2, 0.0, 64, 128).shape == (2, 128, 64)
        assert K.imdct_audio_op(torch.empty(2, 128, 64, device="cuda"), syn, 1000.0, 5.0,
                                0.0, 64, 128).shape == (2, 127 * 64)
        with pytest.raises(ValueError, match="float32"):
            K.mdct_spectro_op(x.double(), mat.double(), 1000.0, 0.2, 0.0, 64, 128)
        with pytest.raises(ValueError, match="contiguous"):
            K.imdct_audio_op(torch.empty(2, 64, 128, device="cuda").transpose(1, 2), syn,
                             1000.0, 5.0, 0.0, 64, 128)
        with pytest.raises(NotImplementedError):
            K.mdct_spectro_op(x, mat, 1000.0, 0.2, 0.0, 32, 128)
        with pytest.raises(ValueError, match="2 frames"):
            K.imdct_audio_op(torch.empty(2, 1, 64, device="cuda"), syn, 1000.0, 5.0, 0.0,
                             64, 128)


def test_ops_are_forward_only(rng):
    x = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32))
    mat = K.spectro_matrix(128)
    with pytest.raises(RuntimeError, match="forward-only"):
        K.mdct_spectro(x.clone().requires_grad_(), mat)
    with pytest.raises(RuntimeError, match="forward-only"):
        K.imdct_audio(K.mdct_spectro(x, mat).requires_grad_(), K.synth_matrix(128))
    # the operator itself, called with grad on, builds no backward it could run
    y = K.mdct_spectro_op(x.clone().requires_grad_(), mat, 0.0, 1.0, 0.0, 64, 128)
    with pytest.raises(RuntimeError, match="autograd"):
        y.sum().backward()
    with torch.no_grad():
        assert K.mdct_spectro(x.clone().requires_grad_(), mat).shape == (2, 65, 64)


def test_inference_fn_runs_the_transform_it_is_given(exported):
    """``build_inference_fn`` calls the transform it was given, a stand-in
    included (``train/grad_truth.py``'s ``SharedSpectra`` feeds another
    transform's spectra so); only an export's own state is read through a
    copy of it."""
    case = exported["fused"]
    opt = TrainOptions().parse(_args(case), save=False)
    transform = SpectralTransform(spectral_config_from_opt(opt), "cpu")

    class StandIn:
        calls = 0

        def __getattr__(self, attr):
            return getattr(transform, attr)

        def lr_forward(self, lr_audio, generator=None, rows=None):
            StandIn.calls += 1
            return transform.lr_forward(lr_audio, generator, rows)

    gen = build_generator(opt)
    gen.load_state_dict(case["state"], strict=True)
    x = torch.from_numpy(case["lr"])
    _, got = build_inference_fn(gen.eval(), StandIn(), out_length=opt.segment_length)(x)
    assert StandIn.calls == 1
    torch.testing.assert_close(got, _port_inference(case)(x)[1], rtol=0, atol=0)
