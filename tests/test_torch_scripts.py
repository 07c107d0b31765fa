"""The port's console scripts in ``pyproject.toml``: each names a callable
``main`` of the port's own CLI module, beside the JAX package's four."""

import importlib
import tomllib
from pathlib import Path

import pytest

PORT = {"mdctgan-torch-train": "mdctgan_tpu_torch.train_cli:main",
        "mdctgan-torch-generate": "mdctgan_tpu_torch.generate_cli:main",
        "mdctgan-torch-export": "mdctgan_tpu_torch.export_cli:main",
        "mdctgan-torch-export-torch": "mdctgan_tpu_torch.export_torch_cli:main"}


@pytest.fixture
def scripts():
    pyproject = Path(__file__).resolve().parents[1] / "pyproject.toml"
    return tomllib.loads(pyproject.read_text())["project"]["scripts"]


@pytest.mark.parametrize("name", sorted(PORT))
def test_port_script_resolves_to_its_cli_main(scripts, name):
    assert scripts[name] == PORT[name]
    module, attr = scripts[name].split(":")
    assert callable(getattr(importlib.import_module(module), attr))


def test_jax_scripts_stay(scripts):
    assert {k: v for k, v in scripts.items() if k not in PORT} == {
        "mdctgan-train": "mdctgan_tpu.train_cli:main",
        "mdctgan-generate": "mdctgan_tpu.generate_cli:main",
        "mdctgan-export-stablehlo": "mdctgan_tpu.export_cli:main",
        "mdctgan-export-torch": "mdctgan_tpu.export_torch_cli:main"}
