"""The float32 convolutions' slices of rows (``models/layers.py``
``f32_conv_rows``, ``conv_forward``) and the benchmark cell that measures
them (``perfbench/configs/flagship-generate-f32.json``,
``perfbench/traffic/requests-long-f32.json``).

On the card a float32 convolution of more than 8 rows runs in slices of 8;
bf16 operands and the CPU keep the whole batch.  The slices are taken on
the CPU here by standing in for the chooser."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from mdctgan_tpu_torch import api
from mdctgan_tpu_torch.models import layers
from mdctgan_tpu_torch.models.generator import build_generator
from mdctgan_tpu_torch.weights import init_weights

REPO = Path(__file__).resolve().parents[1]
CUDA, CPU = torch.device("cuda"), torch.device("cpu")
SMALL = dict(
    n_fft=128, hop_length=64, win_length=128, segment_length=8128, bins=128,
    netG="local", ngf=4, n_downsample_global=2, n_blocks_global=1, n_blocks_local=1,
    n_blocks_attn_g=1, heads_g=2, dim_head_g=4, downsample_type="resconv",
    upsample_type="interpolate",
)


def _generator():
    gen = build_generator(SMALL)
    init_weights(gen, torch.Generator().manual_seed(3))
    return gen


def _input(batch):
    return torch.randn(batch, 2, 128, 64, generator=torch.Generator().manual_seed(batch))


@pytest.mark.parametrize("dtype,device,batch,rows", [
    (torch.float32, CUDA, 16, 8),
    (torch.float32, CUDA, 9, 8),
    (torch.float32, CUDA, 20, 8),
    (torch.float32, CUDA, 8, None),
    (torch.float32, CUDA, 1, None),
    (torch.bfloat16, CUDA, 16, None),
    (torch.float16, CUDA, 16, None),
    (torch.float64, CUDA, 16, None),
    (torch.float32, CPU, 16, None),
    (torch.bfloat16, CPU, 16, None),
    (torch.float32, torch.device("cuda", 1), 20, 8),
])
def test_f32_conv_rows_slices_only_float32_on_the_card(dtype, device, batch, rows):
    assert layers.f32_conv_rows(dtype, device, batch) == rows


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_conv_forward_slices_where_the_chooser_says(monkeypatch, dtype):
    """With the chooser standing in for the card's (slices of 3 for float32
    operands), a float32 call runs one convolution a slice and returns the
    whole batch's output; a bf16 call never asks and runs once."""
    conv = nn.Conv2d(5, 7, 3, padding=1)
    x = torch.randn(8, 5, 6, 9, generator=torch.Generator().manual_seed(0))
    whole = layers.conv_forward(conv, x, dtype)
    asked, calls, conv2d = [], [], F.conv2d

    def rows(d, device, batch):
        asked.append((d, batch))
        return 3 if d == torch.float32 else None

    def counted(t, *args, **kw):
        calls.append(t.shape[0])
        return conv2d(t, *args, **kw)

    monkeypatch.setattr(layers, "f32_conv_rows", rows)
    monkeypatch.setattr(F, "conv2d", counted)
    got = layers.conv_forward(conv, x, dtype)
    if dtype is None:
        assert asked == [(torch.float32, 8)] and calls == [3, 3, 2]
        torch.testing.assert_close(got, whole, rtol=0, atol=1e-6)
    else:
        assert asked == [] and calls == [8]
        assert got.dtype == torch.bfloat16 and torch.equal(got, whole)


def test_cpu_float32_generator_is_bit_for_bit_the_whole_batch(monkeypatch):
    """On the CPU the float32 generator at a batch past 8 runs every
    convolution on its whole batch, as before the slices: its output is bit
    for bit that of the chooser that never slices."""
    gen = _generator().eval()
    x = _input(12)
    with torch.no_grad():
        got = gen(x)
        monkeypatch.setattr(layers, "f32_conv_rows", lambda *a: None)
        want = gen(x)
    assert torch.equal(got, want)


def test_sliced_generator_matches_whole_batch_forward_and_gradients(monkeypatch):
    """Slices of 3 rows in every convolution of a generator in train mode
    (the attention stack's BatchNorm on batch statistics) give the whole
    batch's output and, through autograd, its gradients: each weight's
    gradient is the sum over its slices.  In float64, so that round-off
    flips no ReLU."""
    gen = _generator().double().train()
    x = _input(7).double()
    y = torch.randn(7, 1, 128, 64, generator=torch.Generator().manual_seed(1)).double()

    def run():
        gen.zero_grad(set_to_none=True)
        out = gen(x)
        ((out - y) ** 2).mean().backward()
        return out.detach(), {n: p.grad.clone() for n, p in gen.named_parameters()}

    want, want_g = run()
    slices = []

    def rows(d, device, batch):
        slices.append(batch)
        return 3 if batch > 3 else None

    monkeypatch.setattr(layers, "f32_conv_rows", rows)
    got, got_g = run()
    assert slices and set(slices) == {7}
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    for n, g in want_g.items():
        torch.testing.assert_close(got_g[n], g, rtol=1e-9, atol=1e-12, msg=n)


def _switches():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return dict(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                benchmark_limit=cudnn.benchmark_limit, deterministic=cudnn.deterministic,
                cudnn_tf32=cudnn.allow_tf32, matmul_tf32=matmul.allow_tf32,
                bf16_reduction=matmul.allow_bf16_reduced_precision_reduction,
                precision=torch.get_float32_matmul_precision(),
                deterministic_algorithms=torch.are_deterministic_algorithms_enabled())


@pytest.mark.parametrize("call", ["generator", "upsample", "raise"])
def test_slices_leave_process_switches_as_they_were(monkeypatch, call):
    """The sliced path sets no process-wide switch: cuDNN's and cuBLAS's
    settings, unusual ones included, read the same after a generator
    forward, an ``api.upsample`` call and a convolution that raises as
    before them."""
    monkeypatch.setattr(layers, "f32_conv_rows",
                        lambda d, device, batch: 2 if d == torch.float32 and batch > 2 else None)
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = True, True
    try:
        before = _switches()
        if call == "generator":
            with torch.no_grad():
                _generator().eval()(_input(5))
        elif call == "upsample":
            model = api.create_model(dict(SMALL, seed=4), device="cpu")
            t = np.arange(16000) / 16000
            out = api.upsample((0.1 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 16000,
                               model, is_lr_input=True, batch_size=4)
            assert out.shape == (48000,) and np.isfinite(out).all()
        else:
            with pytest.raises(RuntimeError):
                layers.conv_forward(nn.Conv2d(3, 4, 3), torch.randn(5, 2, 8, 8), None)
        assert _switches() == before
    finally:
        cudnn.benchmark, cudnn.deterministic = saved


# --------------------------------------------------------------------------
# the benchmark cell generate-long-f32
# --------------------------------------------------------------------------

def _json(rel):
    return json.loads((REPO / rel).read_text())


def test_f32_generate_config_is_the_bf16_one_without_fp16():
    bf16 = _json("perfbench/configs/flagship-generate-bf16.json")
    f32 = _json("perfbench/configs/flagship-generate-f32.json")
    assert f32["options"] == dict(bf16["options"], fp16=False)
    assert f32["name"] == "flagship-generate-f32" and f32["source"] == bf16["source"]
    # the one key changed from generate_audio.sh: --fp16 left out
    assert bf16["reduced"] == [] and f32["reduced"] == ["fp16"]
    extra = set(f32["assumed"]) - set(bf16["assumed"])
    assert len(extra) == 1 and all(f32["assumed"][k] == v for k, v in bf16["assumed"].items())
    assert set(f32) == set(bf16) and f32["what"] != bf16["what"]


def test_f32_long_traffic_is_the_long_one_but_its_limit_and_trace_counts():
    long, f32 = (_json(f"perfbench/traffic/{n}.json") for n in ("requests-long",
                                                                "requests-long-f32"))
    changed = {"limits", "trace_requests", "label_requests"}
    assert set(f32) == set(long)
    assert {k: v for k, v in f32.items() if k not in changed} == \
        {k: v for k, v in long.items() if k not in changed}
    assert set(f32["limits"]) == {"spectral_gap"}
    assert 0 < f32["limits"]["spectral_gap"] < long["limits"]["spectral_gap"]
    assert (f32["trace_requests"], f32["label_requests"]) == (20, 5)


# metrics of the bf16 convolutions alone, which a float32 run has nothing for
BF16_ONLY = {"nhwc_conv_share.generate"}


def test_every_metric_of_generate_long_reads_generate_long_f32():
    """Every metric of ``generate-long`` reads the float32 cell too, but
    those of the bf16 convolutions (``BF16_ONLY``), which list the bf16
    serving cells alone."""
    bench = _json("BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == "generate-long-f32")
    assert cell == dict(cell, config="flagship-generate-f32", traffic="requests-long-f32",
                        chips=1)
    metrics = bench["end_to_end"] + bench["per_layer"]
    long = [m["name"] for m in metrics if "generate-long" in m.get("workloads", [])
            and m["name"] not in BF16_ONLY]
    assert len(long) == 9
    for m in metrics:
        if m["name"] in BF16_ONLY:
            assert m["workloads"] == ["generate-long", "generate-clips"], m["name"]
            continue
        assert ("generate-long" in m.get("workloads", [])) == \
            ("generate-long-f32" in m.get("workloads", [])), m["name"]
    assert [c["file"] for c in bench["configs"] if c["name"] == "flagship-generate-f32"] == \
        ["perfbench/configs/flagship-generate-f32.json"]
