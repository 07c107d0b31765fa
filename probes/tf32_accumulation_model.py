#!/usr/bin/env python3
"""A CPU model of the dense form's 3xTF32 product (``csrc/window_gemm.cuh``).

    python3 probes/tf32_accumulation_model.py [--n_fft 960 512] [--frames 80]
    python3 probes/tf32_accumulation_model.py --draws 8 --n_fft 200 --batch 2 --T 24000

Emulates, in numpy, how the tensor cores sum the dense MDCT (K1's product
of the framed signal with the (N, N/2) matrix) and prints K1's error
against float64, raw and normalized (``asinh(1000 y)/ln10 * 0.2``, slope
~87 at 0), for:

* ``f32 torch``: the plain version's float32 ``torch.matmul`` on the CPU;
* ``3xTF32 direct``: a = a_hi + a_lo, w = w_hi + w_lo (each part rounded to
  TF32 to nearest), every m16n8k8 product summed straight into one
  accumulator;
* ``3xTF32 reset/2``: the kernel's scheme: the hi x hi and the two small
  products in separate accumulators that restart every two k8 steps and
  are then added to a float32 accumulator rounded to nearest;
* ``1xTF32``: hi x hi only (``chip_smoke.py``'s control);
* with ``--draws``, also ``5-product``: a split in three TF32 parts (exact),
  w in two, the five largest products, summed as the kernel sums; and per
  draw of the noise the ratio of each error to the f32 plain version's,
  normalized and raw, on ``chip_smoke.py``'s shapes (``--batch``, ``--T``).

The model of one mma: the exact sum of the accumulator and the eight
products, truncated toward zero to float32 (the tensor cores keep the
products exact and truncate where they add).  It is a model: the card's
own errors come from ``chip_smoke.py`` phases 3-4.  On the noise of
``chip_smoke.py`` (sigma sqrt(512/N)) it shows why the kernel restarts its
sums: summed straight into the accumulator the truncation builds up over
the depth (1.6e-3 normalized at N 960, past K1's 5e-4), restarted every
two k8 steps it stays at the float32 plain version's level.  Over draws
(``--draws``) the normalized maximum, one output at the slope of ~87, swings
from draw to draw against the float32 version's (at N 200, batch 2: 3xTF32
up to 2.8x, the 5-product split up to 2.09x, each ~1x at the median), while
the raw product's error stays under half the float32 version's.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mdctgan_tpu_torch.ops.mdct import frame_signal, spectro_matrix  # noqa: E402


def tf32(a: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32, to nearest (ties away from zero)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def parts(x: np.ndarray, n: int) -> list:
    """x as n TF32 parts, each rounding what the others leave."""
    out, rest = [], np.asarray(x, np.float32)
    for _ in range(n):
        p = tf32(rest)
        out.append(p.astype(np.float64))
        rest = (rest - p).astype(np.float32)
    return out


def rz(v: np.ndarray) -> np.ndarray:
    """float64 -> float32, truncated toward zero."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def summed(products: list, hop: int, reset: int) -> np.ndarray:
    """Sum ``products`` ((A part, W part, chain) triples; chain 0 the
    hi x hi, 1 the small products) over two depth halves of ``hop`` in k8
    steps, each mma truncated; ``reset`` 0 sums every product into one
    accumulator, else the chains restart every ``reset`` k8 steps into a
    float32 accumulator rounded to nearest."""
    a0, w0, _ = products[0]
    acc = np.zeros((a0.shape[0], w0.shape[1]), np.float32)
    chains = [np.zeros_like(acc), np.zeros_like(acc)]
    for h in range(2):
        for step, k0 in enumerate(range(h * hop, (h + 1) * hop, 8)):
            sl = slice(k0, min(k0 + 8, (h + 1) * hop))
            for a, w, c in products:
                target = chains[c if reset else 0]
                target[:] = rz(target + a[:, sl] @ w[sl])
            if reset and (step % reset == reset - 1 or k0 + 8 >= (h + 1) * hop):
                acc = (acc.astype(np.float64) + (chains[0].astype(np.float64) + chains[1])
                       ).astype(np.float32)
                chains[0][:], chains[1][:] = 0.0, 0.0
    return acc if reset else chains[0]


def mma_product(a: np.ndarray, w: np.ndarray, hop: int, passes: int, reset: int) -> np.ndarray:
    """a (rows, 2 hop) @ w (2 hop, cols) the kernel's way: 3 (or 1) TF32
    products, or 5 with a split in three parts."""
    if passes == 5:
        (ah, al, a3), (wh, wl) = parts(a, 3), parts(w, 2)
        return summed([(a3, wh, 1), (al, wl, 1), (al, wh, 1), (ah, wl, 1), (ah, wh, 0)],
                      hop, reset)
    (ah, al), (wh, wl) = parts(a, 2), parts(w, 2)
    small = [(al, wh, 1), (ah, wl, 1)] if passes == 3 else []
    return summed(small + [(ah, wh, 0)], hop, reset)


def normalized(y: np.ndarray) -> np.ndarray:
    return np.arcsinh(1000.0 * y) / np.log(10.0) * 0.2


def frames_of(n: int, x: np.ndarray) -> np.ndarray:
    return frame_signal(torch.from_numpy(x.astype(np.float32)), n, n // 2).numpy().reshape(-1, n)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_fft", type=int, nargs="+", default=[960, 512])
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--draws", type=int, default=0,
                    help="draws of the noise for the ratio to the f32 plain version")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--T", type=int, default=24000)
    args = ap.parse_args(argv)
    for n in args.n_fft:
        hop = n // 2
        w64 = spectro_matrix(n, dtype=torch.float64).numpy()
        w32 = w64.astype(np.float32)
        if args.draws:
            ratios = {}
            for seed in range(args.draws):
                rng = np.random.default_rng(seed)
                fr = frames_of(n, np.sqrt(512 / n) * rng.standard_normal((args.batch, args.T)))
                truth = fr.astype(np.float64) @ w64
                plain = (torch.from_numpy(fr) @ torch.from_numpy(w32)).numpy()
                for name, passes in (("3xTF32 reset/2", 3), ("5-product reset/2", 5)):
                    y = mma_product(fr, w32, hop, passes, 2)
                    for kind, f in (("normalized", normalized), ("raw", lambda v: v)):
                        ratios.setdefault((name, kind), []).append(
                            np.abs(f(y) - f(truth)).max() / np.abs(f(plain) - f(truth)).max())
            for (name, kind), r in ratios.items():
                print(json.dumps({"n_fft": n, "batch": args.batch, "T": args.T, "model": name,
                                  "error": kind, "draws": args.draws,
                                  "ratio_to_f32_max": max(r),
                                  "ratio_to_f32_median": float(np.median(r))}))
            continue
        rng = np.random.default_rng(0)
        frames = frames_of(n, np.sqrt(512 / n) * rng.standard_normal((1, (args.frames - 1) * hop)))
        truth = frames.astype(np.float64) @ w64
        runs = {
            "f32 torch": (torch.from_numpy(frames) @ torch.from_numpy(w32)).numpy(),
            "3xTF32 direct": mma_product(frames, w32, hop, 3, 0),
            "3xTF32 reset/2": mma_product(frames, w32, hop, 3, 2),
            "1xTF32": mma_product(frames, w32, hop, 1, 2),
        }
        for name, y in runs.items():
            print(json.dumps({"n_fft": n, "frames": args.frames, "model": name,
                              "raw_max_abs_err": float(np.abs(y - truth).max()),
                              "normalized_max_abs_err": float(
                                  np.abs(normalized(y) - normalized(truth)).max())}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
