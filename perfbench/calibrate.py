"""The readings that the limits of ``correct`` are set from, for one cell,
in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--seconds 3]

For each seed: the port's numbers against the reference (a train cell's
set-up steps, or a generate cell's window of ``--seconds`` and its checked
sample).  For each control seed also the control's, the reference in
float8 put in the port's place, and for a train cell the half-batch
fault's, the reference on the first half of each batch, the wrong-loss
fault's, the reference without feature matching, the flipped update's, the
reference with Adam's step negated, and the flipped backward's, the
program's first gradient negated.  A state left unchanged reads 1 on
``change_gap`` and ``change_dir`` by the numbers' definition and needs no
run.  Prints one JSON line a reading, with the worst leaves of a train
cell's leaf numbers.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import checks, harness  # noqa: E402
from perfbench.reference.precision import FP8  # noqa: E402


def worst_leaves(program, reference, key, keep=None, n=3):
    nets = {}
    for k, v in reference[key].items():
        if keep is None or k in keep:
            nets.setdefault(k[0], {})[k] = v
    rows = []
    for leaves in nets.values():
        med = statistics.median(leaves.values())
        rows += [(abs(program[key][k] - r) / max(r, med), k, program[key][k], r, med)
                 for k, r in leaves.items()]
    return [[round(g, 6), k, p, r, m] for g, k, p, r, m in sorted(rows, reverse=True)[:n]]


def reference_with(cell, **changes):
    """The reference under other options: a fault planted in it."""
    opt = cell.opt
    cell.opt = dict(opt, **changes)
    try:
        return cell.reference()
    finally:
        cell.opt = opt


def train_reading(cell, seed, control):
    ref = cell.reference()
    out = [("program", cell.program)]
    if control:
        out += [("control", cell.reference(FP8)),
                ("half_batch", cell.reference(batch_rows=cell.opt["batchSize"] // 2)),
                ("no_feature_matching", reference_with(cell, lambda_feat=0.0)),
                ("update_flipped", reference_with(cell, lr=-cell.opt["lr"]))]
    keep = checks.moving_leaves(ref["grad_norms"])
    for kind, got in out:
        yield {"seed": seed, "kind": kind, **checks.train_numbers(got, ref, cell.start_bn()),
               **checks.diagnostics(got, ref),
               "worst_change": worst_leaves(got, ref, "change_norms", keep)}
    if control:  # the backward's sign flipped: the first gradient negated, exactly
        flipped = {k: -v for k, v in cell.program["grads"].items()}
        gaps = checks.net_gaps(checks.leaf_sums(flipped, ref["grads"], sorted(keep)))
        yield {"seed": seed, "kind": "sign_flip", **{f"grad_dir.{n}": v for n, v in gaps.items()}}


def generate_reading(cell, seed, control):
    which = cell.sample()
    ref = cell.reference(which)
    yield {"seed": seed, "kind": "program", "requests": len(cell.outputs), "checked": len(which),
           **checks.serve_numbers([cell.outputs[i] for i in which], ref, cell.spectrum)}
    if control:
        yield {"seed": seed, "kind": "control",
               **checks.serve_numbers(cell.reference(which, FP8), ref, cell.spectrum)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = harness.find_cell(ROOT, args.workload)
    device = harness.card(cell.workload["chips"])
    if device is None:
        print("calibrate: no card", file=sys.stderr)
        return 2
    driver = cell.driver()
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Context(cell, seed, args.seconds, False, device, t0)
        if cell.traffic["driver"] == "train":
            c = driver.TrainCell(ctx)
            c.setup()
            c.release()
            readings = train_reading(c, seed, seed in controls)
        else:
            c = driver.GenerateCell(ctx)
            c.setup()
            c.window()
            c.release()
            readings = generate_reading(c, seed, seed in controls)
        for r in readings:
            print(json.dumps({**r, "s": round(time.perf_counter() - t0, 2)}), flush=True)
        del c
    return 0


if __name__ == "__main__":
    sys.exit(main())
