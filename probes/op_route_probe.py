"""The host's cost of the serving path's calls into K1 and K2, compared
across checkouts on one GPU.

    python3 probes/op_route_probe.py ROOT [ROOT ...]

For each ROOT (a checkout of this repository, such as a parent commit
unpacked under ``build/parent``), in the order given and each in a process
of its own (the trees share the package's name):

  * the eager time of one call of each FFT-form wrapper
    (``mdct_kernels.mdct_spectro``, ``imdct_audio``) at n_fft 512 and batch
    8: the mean of 10 back-to-back calls by CUDA events, the median of 25
    after 3 warm-ups, as ``chip_smoke.py`` phase 7's ``eager_ms``;
  * ``api.upsample`` of a 3.7 s request of synthetic speech at 16 kHz
    through the flagship (``configs.flagship_opt()``, seeded weights), batch
    8, in float32 and in bf16: host clock, a warm-up then the median of 20,
    as phase 7 times it.

Give two trees as ``A B B A`` so that each is measured early and late in
the call.  One JSON line per tree and run, times in ms, with the card's
name and power limit.  Run it from the repository root on a machine with
one CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REQUEST_S = 3.7
RUNS = 20


def measure(root: Path) -> dict:
    """This process's numbers for the tree at ``root``."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from mdctgan_tpu_torch import api
    from mdctgan_tpu_torch.configs import flagship_opt
    from mdctgan_tpu_torch.data.synthetic import speech_like
    from mdctgan_tpu_torch.device import float32_policy
    from mdctgan_tpu_torch.models.generator import build_generator
    from mdctgan_tpu_torch.ops import _build
    from mdctgan_tpu_torch.ops import mdct_kernels as K
    from mdctgan_tpu_torch.weights import random_jax_trees, state_dict_from_jax

    if not Path(K.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"{K.__file__} is not under {root}")
    _build.build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {}
    with float32_policy():
        x = torch.from_numpy(rng.standard_normal((8, 32512)).astype(np.float32)).to(dev)
        y = torch.from_numpy(rng.uniform(-1, 1, (8, 128, 256)).astype(np.float32)).to(dev)
        mat, syn = K.spectro_matrix(512, dev), K.synth_matrix(512, dev)
        for name, fn in (("mdct_spectro", lambda: K.mdct_spectro(x, mat, 1000.0, 0.2, 0.0)),
                         ("imdct_audio", lambda: K.imdct_audio(y, syn, 1000.0, 5.0, 0.0))):
            for _ in range(3):
                fn()
            times = []
            for _ in range(25):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 10)
            out[f"{name}_eager_ms"] = statistics.median(times)

        opt = flagship_opt()
        state = state_dict_from_jax(*random_jax_trees(build_generator(opt), rng))
        audio = speech_like(rng, REQUEST_S)
        for precision, run_opt in (("f32", opt), ("bf16", dict(opt, fp16=True))):
            model = api.create_model(run_opt, dev, state_dict=state)
            api.upsample(audio, 16000, model, is_lr_input=True, gen_overlap=512)
            walls = []
            for _ in range(RUNS):
                t0 = time.perf_counter()
                api.upsample(audio, 16000, model, is_lr_input=True, gen_overlap=512,
                             batch_size=8)
                walls.append((time.perf_counter() - t0) * 1e3)
            out[f"upsample_{precision}_ms"] = statistics.median(walls)
            del model
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(measure(Path(argv[1]))), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    for i, root in enumerate(argv):
        proc = subprocess.run([sys.executable, __file__, "--one", str(Path(root).resolve())],
                              capture_output=True, text=True, check=True, timeout=900)
        record = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "root": root, "card": smi, **record}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
