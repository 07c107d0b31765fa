"""Check a reference-format ``.pth`` against the model flags before serving
it: the port of ``tools/verify_import.py``, which needs JAX.

    python -m mdctgan_tpu_torch.verify_import_cli <ckpt.pth> \\
        [--net auto|G|D] [--forward] [model flags...]

It reports what ``train/import_torch.py`` would do with a ``*_net_G.pth``
or ``*_net_D.pth`` (the reference's published files, or what
``export_torch_cli`` writes) for the architecture the flags describe, line
for line as the JAX tool prints it:

  * the expected required and optional reference keys;
  * the matched keys, and how many came through ``--param_key_map``;
  * the ``MISSING`` keys, each with the leftover keys of its size;
  * the leftover keys, which the importer ignores;
  * each ``SHAPE MISMATCH``;
  * whether the strict load, with no fallback rung, succeeds.

A present key of the wrong shape counts as not consumed, so
``--param_key_map`` may rename it, as in the importer.  The expected shapes
come from the port's module built on the ``meta`` device (no memory, no
arithmetic), so the report needs no device.

``--forward`` imports for real and runs one forward pass on
``0.1 * sin(arange)``, laid out as the JAX tool lays it out (NHWC
``(1, n_bins, n_fft/2, channels)``) and permuted to the port's NCHW; for D,
the last scale's last logits.  It prints the output's shape, mean, std and
a checksum of its values rounded to 1e-4, all in NHWC order, so that the
two tools' lines can be compared.  It runs on ``cuda:<gpu_ids>`` (default
0; raises without CUDA); ``--gpu_ids -1`` asks for the CPU.

Exit status: 0 if and only if the strict load succeeds, else 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import tempfile
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from mdctgan_tpu_torch.device import float32_policy
from mdctgan_tpu_torch.options import TrainOptions, serving_devices, spectral_config_from_opt
from mdctgan_tpu_torch.train import import_torch
from mdctgan_tpu_torch.weights import init_weights


@dataclasses.dataclass
class Verified:
    """What ``verify`` found: the strict load's verdict and, with
    ``--forward``, the imported module, its NCHW input and its output in
    NHWC order."""

    ok: bool
    net: str
    module: Optional[torch.nn.Module] = None
    input: Optional[torch.Tensor] = None
    output: Optional[np.ndarray] = None


def _build(net: str, opt) -> torch.nn.Module:
    if net == "G":
        from mdctgan_tpu_torch.models.generator import build_generator

        return build_generator(opt)
    from mdctgan_tpu_torch.models.discriminator import build_discriminator

    return build_discriminator(opt)


def _entries(net: str, opt, module: torch.nn.Module) -> List[import_torch.Entry]:
    if net == "G":
        return import_torch.generator_entries_for(module)
    return import_torch.discriminator_entries(opt.num_D, opt.n_layers_D)


def report(sd: Dict[str, torch.Tensor], entries, expected_shapes: Mapping[str, Tuple[int, ...]],
           key_map: Optional[Mapping[str, str]], label: str) -> bool:
    """The key-set and shape audit, printed; whether the strict load
    succeeds.  ``sd`` takes the renames of ``key_map``."""
    req, opt_keys = import_torch.expected_torch_keys(entries)
    expected = set(req) | set(opt_keys)
    present = set(sd)

    renamed = {}
    if key_map:
        consumed_ok = {k for k in expected & present
                       if expected_shapes.get(k) is None
                       or tuple(expected_shapes[k]) == tuple(sd[k].shape)}
        before = set(sd)
        sd2 = import_torch.apply_param_key_map(dict(sd), key_map, consumed_ok)
        renamed = set(sd2) - before
        sd.clear()
        sd.update(sd2)
        present = set(sd)

    matched = sorted(present & expected)
    missing = [k for k in req if k not in present]
    leftover = sorted(present - expected)
    shape_bad = [(k, expected_shapes[k], tuple(sd[k].shape)) for k in matched
                 if k in expected_shapes and tuple(expected_shapes[k]) != tuple(sd[k].shape)]

    print(f"[{label}] expected keys: {len(req)} required + {len(opt_keys)} optional")
    print(f"[{label}] matched: {len(matched)}"
          + (f" ({len(renamed)} via --param_key_map)" if renamed else ""))
    if missing:
        print(f"[{label}] MISSING ({len(missing)}):")
        by_shape: Dict[Tuple[int, ...], List[str]] = {}
        for k in leftover:
            by_shape.setdefault(tuple(sd[k].shape), []).append(k)
        for k in missing:
            cands = by_shape.get(tuple(expected_shapes.get(k, ())), [])
            hint = f"   <- size-matched candidates: {cands}" if cands else ""
            print(f"    {k}  (expected {expected_shapes.get(k)}){hint}")
    if leftover:
        print(f"[{label}] leftover (ignored by the importer, {len(leftover)}): {leftover[:6]}"
              + (" ..." if len(leftover) > 6 else ""))
    if shape_bad:
        print(f"[{label}] SHAPE MISMATCH ({len(shape_bad)}):")
        for k, want, got in shape_bad:
            print(f"    {k}: expected {tuple(want)}, file has {got}")
    ok = not missing and not shape_bad
    print(f"[{label}] strict load: {'OK — 100% matched' if ok else 'WOULD FALL BACK (see above)'}")
    return ok


def forward_input(in_shape: Tuple[int, int, int, int]) -> torch.Tensor:
    """The JAX tool's input, ``0.1 * sin(arange)`` in NHWC ``in_shape``, as
    the port's NCHW tensor."""
    x = 0.1 * np.sin(np.arange(int(np.prod(in_shape)), dtype=np.float32)).reshape(in_shape)
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def imported(net: str, opt, sd: Mapping[str, torch.Tensor], key_map,
             device: torch.device) -> torch.nn.Module:
    """The module the flags build, its weights imported from ``sd`` through
    the fallback ladder (what the file lacks keeps the reference
    initialisation, seeded by 0), in eval mode on ``device``."""
    module = _build(net, opt)
    init_weights(module, torch.Generator().manual_seed(0))
    if net == "G":
        state, _ = import_torch.import_generator(sd, module, param_key_map=key_map)
    else:
        state, _ = import_torch.import_discriminator(sd, module, opt.num_D, opt.n_layers_D,
                                                     param_key_map=key_map)
    module.load_state_dict(state, strict=True)
    return module.to(device).eval()


def verify(argv: Optional[Sequence[str]] = None) -> Verified:
    """Run the tool on ``argv`` (``sys.argv`` when None): print the report
    and, with ``--forward``, the forward pass's line."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("pth", help="path to a *_net_G.pth or *_net_D.pth")
    ap.add_argument("--net", choices=["auto", "G", "D"], default="auto")
    ap.add_argument("--forward", action="store_true",
                    help="import for real and run one deterministic forward")
    args, rest = ap.parse_known_args(argv)

    # model flags only; nothing is written beside the user's files
    with tempfile.TemporaryDirectory(prefix="verify_import_") as tmp:
        opt = TrainOptions().parse(["--checkpoints_dir", tmp, "--name", "audit"] + rest,
                                   save=False)

    net = args.net
    if net == "auto":
        net = "D" if os.path.basename(args.pth).endswith("_net_D.pth") else "G"
        print(f"[verify] net kind inferred from filename: {net}")

    sd = import_torch.load_pth(args.pth)
    cfg = spectral_config_from_opt(opt)
    channels = opt.input_nc if net == "G" else opt.input_nc + opt.output_nc
    in_shape = (1, cfg.n_bins, cfg.n_fft // 2, channels)
    key_map = getattr(opt, "param_key_map", None) or None

    with torch.device("meta"):
        template = _build(net, opt)
    entries = _entries(net, opt, template)
    shapes = import_torch._torch_shapes(
        entries, {k: tuple(v.shape) for k, v in template.state_dict().items()})
    ok = report(sd, entries, shapes, key_map, f"net_{net}")
    if not args.forward:
        return Verified(ok, net)

    device = serving_devices(opt)[0]
    print(f"[net_{net}] importing + forward (this initializes the module"
          " — may take a minute on large geometries)...")
    module = imported(net, opt, sd, key_map, device)
    x = forward_input(in_shape).to(device)
    with torch.inference_mode(), float32_policy():
        y = module(x)
        if net == "D":
            y = y[-1][-1]  # the last scale's last logits
        arr = y.float().permute(0, 2, 3, 1).cpu().numpy()
    digest = hashlib.sha256(np.round(arr.astype(np.float64), 4).tobytes()).hexdigest()[:16]
    print(f"[net_{net}] forward OK: out shape {arr.shape}, "
          f"mean {arr.mean():+.6f}, std {arr.std():.6f}, checksum(1e-4) {digest}")
    return Verified(ok, net, module, x, arr)


def main(argv: Optional[Sequence[str]] = None) -> int:
    return 0 if verify(argv).ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
