"""Whole runs on the CPU, the look for a card skipped: the result line,
the refusal without a card, ``BENCHMARK.json``'s rules, a cell and a
metric added as files alone, the tiny cells coming out correct, and the
timed path broken underneath (each fault a cell can have, a backward or an
update with its signs flipped, a loss left out, and the float8 control in
the port's place, which in float32 comes out correct) coming out not
correct."""

import copy
import json
import re
import time

import pytest
import torch

import perfbench_tiny as T
from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((T.REPO / "BENCHMARK.json").read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return T.make_root(tmp_path_factory.mktemp("perfbench"))


# ----------------------------------------------------------- BENCHMARK.json
def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("perfbench/") and (T.REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert json.loads((T.REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] in (1, 4)
        traffic = T.REPO / "perfbench" / "traffic" / f"{w['traffic']}.json"
        driver = json.loads(traffic.read_text())["driver"]
        assert (T.REPO / "perfbench" / "drivers" / f"{driver}.py").is_file()
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (T.REPO / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]} if "workloads" in m \
            else True
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    # the check's length with the full 24 cells
    assert (BENCH["run_seconds"] + 60) * (2 + 14 * 24) + 24 * 180 + 1200 <= 43200


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        reported = {n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reported and len(reported) >= 2
        layers = [m for m in BENCH["per_layer"] if w["name"] in m["workloads"]]
        assert layers and all(m["moves"] in reported for m in layers)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


# ------------------------------------------------------------ the last line
STUB_DRIVER = '''
from perfbench.harness import Record
from perfbench.trace import Record as Span, Trace


def run(ctx):
    rec = Record("train", setup_s=1.5, window_s=2.0, items=10, samples=200)
    rec.correct, rec.checks = True, {"x": {"value": 0.0, "limit": 1.0}}
    if ctx.trace:
        rec.trace = Trace([Span(0, 5, "k")], [], [], 1e-5)
    return rec
'''


@pytest.fixture(scope="module")
def stub_root(root):
    """A cell, its configuration, its traffic, its driver and a metric,
    each added as a file and an entry."""
    pb = root / "perfbench"
    (pb / "drivers" / "stub.py").write_text(STUB_DRIVER)
    (pb / "traffic" / "stub-mix.json").write_text('{"driver": "stub"}')
    (pb / "configs" / "stub-config.json").write_text('{"reduced": [], "options": {}}')
    (pb / "metrics" / "stub_items_x2.py").write_text("def read(rec):\n    return rec.items * 2\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "stub-config", "source": "test", "reduced": [], "why": "t",
                             "file": "perfbench/configs/stub-config.json"})
    bench["workloads"].append({"name": "stub-cell", "config": "stub-config",
                               "traffic": "stub-mix", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("stub-cell")
    bench["per_layer"].append({"name": "stub_items_x2", "unit": "items", "better": "higher",
                               "source": "host_clock", "layer": "stub",
                               "moves": "train_samples_per_s", "workloads": ["stub-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_one_json_last_line(stub_root, trace, capsys):
    rc = harness.run(["--workload", "stub-cell", "--seed", str(2**33 + 1), "--seconds", "1",
                      "--trace", str(trace)], time.perf_counter(), stub_root,
                     device=torch.device("cpu"))
    out, err = capsys.readouterr()
    assert rc == 0
    lines = out.strip().splitlines()
    line = json.loads(lines[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["attempted"] == 10 and line["correct"] is True and line["failed"] == 0
    if trace:
        assert line["metrics"] == {"stub_items_x2": {"value": 20.0, "unit": "items"}}
        assert line["device"]["busy_s"] == pytest.approx(5e-6)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"setup_s", "train_samples_per_s"}
        assert line["metrics"]["train_samples_per_s"]["value"] == 100.0
    assert err.strip().splitlines()[-1] == "check x 0.0 limit 1.0"


def test_no_card_no_result(stub_root, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.run(["--workload", "stub-cell", "--seed", "1", "--seconds", "1"],
                     time.perf_counter(), stub_root)
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


def test_jax_loaded_means_no_result(stub_root, monkeypatch, capsys):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = harness.run(["--workload", "stub-cell", "--seed", "1", "--seconds", "1"],
                     time.perf_counter(), stub_root, device=torch.device("cpu"))
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "jax" in err
    assert harness.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    import mdctgan_tpu_torch  # noqa: F401  (its name begins with the JAX package's)

    assert harness.forbidden_modules() == []


# ------------------------------------------------------------- tiny cells
@pytest.mark.parametrize("cell", list(T.CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cells_come_out_correct(root, cell, trace):
    rc, line = T.run(root, cell, seed=2**31 + 3, trace=trace)
    assert rc == 0 and line["correct"] is True, line["checks"]
    assert line["attempted"] > 0
    metrics = set(line["metrics"])
    if trace:
        assert "breakdown" in line and line["device"]["window_s"] > 0
        assert metrics >= ({"step_enqueue_ms", "g_forward_ms", "backward_ms"}
                           if "train" in cell else set())
    else:
        assert "setup_s" in metrics and len(metrics) >= 2


def flip_port_gradients(monkeypatch):
    """``torch.autograd.grad`` negated inside the port's train step: a
    backward whose signs are flipped."""
    grad, inside = torch.autograd.grad, []

    def flipped(*args, **kw):
        out = grad(*args, **kw)
        return tuple(None if g is None else -g for g in out) if inside else out

    monkeypatch.setattr(torch.autograd, "grad", flipped)
    return inside


def break_train_step(monkeypatch, fault):
    """The port's train step with ``fault`` planted underneath."""
    from mdctgan_tpu_torch.train import step as step_module

    build = step_module.build_train_step
    inside = flip_port_gradients(monkeypatch) if fault == "sign_flip" else None
    if fault == "no_feature_matching":  # a loss left out where it is made
        monkeypatch.setattr(step_module, "feature_matching_loss",
                            lambda fake, *a, **k: 0.0 * fake[0][0].sum())
        return

    def broken_build(*args, **kw):
        step = build(*args, **kw)

        def broken(state, batch, *a, **k):
            if fault == "half_batch":
                half = batch["lr_audio"].shape[0] // 2
                return step(state, {n: v[:half] for n, v in batch.items()}, *a, **k)
            if fault == "sign_flip":
                inside.append(True)
                try:
                    return step(state, batch, *a, **k)
                finally:
                    inside.pop()
            if fault == "update_flipped":
                params = [p for n in (state.generator, state.discriminator)
                          for p in n.parameters()]
                before = [p.detach().clone() for p in params]
                state, metrics = step(state, batch, *a, **k)
                with torch.no_grad():
                    for p, b in zip(params, before):
                        p.copy_(2 * b - p)
                return state, metrics
            nets = (state.generator, state.discriminator)
            saved = [copy.deepcopy(n.state_dict()) for n in nets]
            opts = [copy.deepcopy(o.state_dict()) for o in (state.g_opt, state.d_opt)]
            state, metrics = step(state, batch, *a, **k)
            for n, sd in zip(nets, saved):
                n.load_state_dict(sd)
            for o, sd in zip((state.g_opt, state.d_opt), opts):
                o.load_state_dict(sd)
            return state, metrics

        return broken

    monkeypatch.setattr(step_module, "build_train_step", broken_build)


def alter_answers(monkeypatch):
    from mdctgan_tpu_torch import api

    serve = api.serve_segments

    def altered(*args, **kw):
        out = serve(*args, **kw)
        out[0] = out[0][::-1].copy()  # the first segment's answer, time-reversed
        return out

    monkeypatch.setattr(api, "serve_segments", altered)


@pytest.mark.parametrize("cell,fault", [
    ("tiny-train-device", "unchanged"), ("tiny-train-device", "half_batch"),
    ("tiny-train-device", "sign_flip"), ("tiny-train-device", "update_flipped"),
    ("tiny-train-device", "no_feature_matching"),
    ("tiny-train-pipeline", "unchanged"), ("tiny-train-pipeline", "half_batch"),
    ("tiny-train-pipeline", "sign_flip"), ("tiny-generate", "altered")])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    if fault == "altered":
        alter_answers(monkeypatch)
    else:
        break_train_step(monkeypatch, fault)
    rc, line = T.run(root, cell, seed=11)
    assert rc == 0 and line["correct"] is False
    failed = {k for k, v in line["checks"].items() if v["value"] > v["limit"]}
    assert failed >= {"unchanged": {"change_gap"}, "half_batch": {"bn_gap"},
                      "sign_flip": {"grad_dir.D"}, "update_flipped": {"descent.D"},
                      "no_feature_matching": {"first_loss_gap"},
                      "altered": {"spectral_gap"}}[fault]


# ----------------------------------------------------------- the control
def put_control_in_place(monkeypatch, cell, prec):
    """The reference in ``prec`` (``reference/precision.py``) in the port's
    place: the serving chain, or the train step on the port's state, whose
    BatchNorm statistics it moves as the port's step would."""
    from mdctgan_tpu_torch import api
    from mdctgan_tpu_torch.train import step as step_module

    from perfbench.reference import models, serve, train, transform

    opt = T.TRAIN if "train" in cell else T.GENERATE

    def tr(device):
        return transform.Transform(opt["n_fft"], opt["arcsinh_gain"], opt["src_range"],
                                   opt["norm_range"], device)

    if "generate" in cell:
        def upsample(audio, rate, model, **kw):
            g = models.build_generator(opt, prec).to(model.device)
            g.load_state_dict(model.generator.state_dict())
            return serve.upsample_many([audio], rate, g, tr(model.device), opt, model.device,
                                       opt["batchSize"])[0]

        monkeypatch.setattr(api, "upsample", upsample)
        return

    def build(transform_, g_tx, d_tx, **kw):
        dev = transform_.device

        def step(state, batch, mark=None):
            nets = [(models.build_generator(opt, prec), state.generator),
                    (models.Discriminator(opt, prec), state.discriminator)]
            for ref, port in nets:
                ref.to(dev).load_state_dict(port.state_dict())
            with torch.no_grad():
                lr, hr = tr(dev).spectrum(batch["lr_audio"]), tr(dev).spectrum(batch["hr_audio"])
            ls = train.losses(nets[0][0], nets[1][0], lr, hr, opt)
            pairs = [(p, dict(port.named_parameters())[k])
                     for ref, port in nets for k, p in ref.named_parameters()]
            grads = torch.autograd.grad(ls["loss_G"] + ls["loss_D"], [p for p, _ in pairs])
            for (_, port_p), g in zip(pairs, grads):
                port_p.grad = g
            with torch.no_grad():
                for ref, port in nets:
                    buffers = dict(port.named_buffers())
                    for k, b in ref.named_buffers():
                        buffers[k].copy_(b)
            state.g_opt.step()
            state.d_opt.step()
            state.step += 1
            return state, {k: v.detach() for k, v in ls.items()}

        return step

    monkeypatch.setattr(step_module, "build_train_step", build)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("cell", ["tiny-train-device", "tiny-generate"])
def test_the_control_is_not_correct(root, monkeypatch, cell, device):
    from perfbench.reference.precision import FP8

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    put_control_in_place(monkeypatch, cell, FP8)
    rc, line = T.run(root, cell, seed=5, device=device)
    assert rc == 0 and line["correct"] is False
    failed = {k for k, v in line["checks"].items() if v["value"] > v["limit"]}
    assert failed >= ({"bn_gap"} if "train" in cell else {"spectral_gap"})


@pytest.mark.parametrize("cell", ["tiny-train-device", "tiny-generate"])
def test_the_reference_in_the_ports_place_is_correct(root, monkeypatch, cell):
    """The control's harness with float32 operands: what makes the control
    fail is its precision, not the way it was put in place."""
    from perfbench.reference.precision import FLOAT32

    put_control_in_place(monkeypatch, cell, FLOAT32)
    rc, line = T.run(root, cell, seed=5)
    assert rc == 0 and line["correct"] is True, line["checks"]
