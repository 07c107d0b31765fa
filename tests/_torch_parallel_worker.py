"""Ranks for ``tests/test_torch_parallel.py``.

``sgd_step`` is what ``parallel.mesh.spawn`` runs in each rank: one SGD(1)
train step of the port on the rank's rows of a global batch.  Run as a
script, the module is one ``--multihost`` rank of the port's train CLI
(the rank and the group from torchrun's variables in the environment):

    python tests/_torch_parallel_worker.py --multihost --gpu_ids -1 ...

and prints, as its last line, what the rank did as JSON.  It imports the
port alone, never JAX, so each rank starts in seconds.
"""

import functools
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mdctgan_tpu_torch import train_cli  # noqa: E402
from mdctgan_tpu_torch.models.discriminator import MultiscaleDiscriminator  # noqa: E402
from mdctgan_tpu_torch.models.generator import LocalEnhancer  # noqa: E402
from mdctgan_tpu_torch.ops.features import SpectralConfig, SpectralTransform  # noqa: E402
from mdctgan_tpu_torch.parallel import mesh  # noqa: E402
from mdctgan_tpu_torch.train.checkpoint import state_digest  # noqa: E402
from mdctgan_tpu_torch.train.schedule import OptimizerSpec  # noqa: E402
from mdctgan_tpu_torch.train.state import create_train_state  # noqa: E402
from mdctgan_tpu_torch.train.step import build_train_step  # noqa: E402


def sgd_step(ranks, g_sd, d_sd, g_cfg, d_cfg, spectral, batch, mask):
    """One SGD(1) step on this rank's rows of ``batch`` (numpy, the global
    batch) weighted by its rows of ``mask``, from the state dicts ``g_sd``
    and ``d_sd``.  Returns the metrics, the state after the step as numpy,
    its digest, and two collectives read back: every rank's rank gathered
    (``gather_rows``) and whether any rank is odd (``any_rank``)."""
    sgd = OptimizerSpec(functools.partial(torch.optim.SGD, lr=1.0))
    gen, disc = LocalEnhancer(**g_cfg), MultiscaleDiscriminator(3, **d_cfg)
    gen.load_state_dict(g_sd, strict=True)
    disc.load_state_dict(d_sd, strict=True)
    state = create_train_state(gen, disc, sgd, sgd, device="cpu", ranks=ranks)
    step = build_train_step(SpectralTransform(SpectralConfig(**spectral), "cpu"), sgd, sgd,
                            n_layers_d=d_cfg["n_layers"], num_d=d_cfg["num_D"], ranks=ranks)
    rows = ranks.host_rows(len(mask))
    state, metrics = step(state, {k: torch.from_numpy(v[rows]) for k, v in batch.items()},
                          sample_mask=torch.from_numpy(mask[rows]))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "generator": {k: v.numpy() for k, v in state.generator.state_dict().items()},
            "discriminator": {k: v.numpy() for k, v in state.discriminator.state_dict().items()},
            "digest": state_digest(state),
            "gathered": mesh.gather_rows(torch.full((2,), float(ranks.rank)), ranks).tolist(),
            "any_odd": mesh.any_rank(ranks.rank % 2 == 1, ranks)}


def main(argv) -> None:
    result = train_cli.main(argv)
    print(json.dumps({"digest": state_digest(result["state"]), "losses": result["losses"],
                      "launches": result["launches"], "saves": len(result["saves"]),
                      "writes": len(result["writes"]), "evals": len(result["evals"]),
                      "agree_ms": [s["agree_ms"] for s in result["steps"]],
                      "interrupted": result["interrupted"]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
