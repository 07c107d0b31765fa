"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``.  Libraries go to ``build/torch_kernels/`` at the repository root
(git-ignored) under a name that carries a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is reused.  Nothing is built
when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("mdct_spectro", "imdct_audio")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if not cand.exists():
            raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin)")
        path = str(cand)
    return path


def _digest(name: str) -> str:
    # every source, since one .cu may include another
    h = hashlib.sha256(f"{name} {' '.join(NVCC_FLAGS)}".encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    per source, all started together.  Returns each kernel's ``ptxas`` report
    (registers, shared memory, spills); empty for a library already built.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load_library(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name``, building it first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
