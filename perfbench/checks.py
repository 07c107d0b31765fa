"""The comparison that decides ``correct``: the numbers that hold what the
timed path produced against the plain reference, and their limits.

Training (the first three steps of the state the window then trains; the
program's first gradient is Adam's first moment after step 1 over
``1 - beta1``):

* ``bn_gap``: for each running statistic of G's BatchNorms (the
  attention stack's), the norm of the program's minus the reference's
  after step 1, over the norm of the reference's move in that step
  (``r1 - 0.9 r0``: momentum 0.1), the worst one: the batch statistics of
  the step's first G forward, which the rows of the batch and its
  arithmetic set;
* ``change_gap``: for each leaf of G and of D, the gap between the
  program's and the reference's norm of the leaf's change over the three
  steps, over the reference's norm of that leaf or of its network's
  median leaf, whichever is larger; the worst leaf.  Leaves whose
  reference gradient at step 1 is under a thousandth of their network's
  median leaf are left out: biases in front of a norm, whose gradient is
  nought to rounding (in bf16 a sum of round-off as large as the median
  leaf's) and which Adam moves by round-off alone;
* ``first_loss_gap``: the first step's worst relative gap over the six
  losses (a wrong loss);
* ``grad_dir.D``: ``||g - g_ref|| / ||g_ref||`` of D's first gradient over
  its moving leaves together (a backward with its signs flipped reads 2);
* ``descent.D``: ``1 - <g_ref, dp> / <g_ref, dp_ref>`` over D's moving
  leaves, dp each side's change over the three steps: the share of the
  reference's first-order descent that the program's updates miss (an
  update of the wrong sign reads about 2).

G's direction numbers (``grad_dir.G``, ``change_dir.G``, ``descent.G``)
and the later steps' losses read within 2x of the float8 control in the
bf16 port, whose G gradient is chaotic at its random start (PERF.md §2):
``calibrate.py`` reads them, the check does not.

Serving: ``spectral_gap``, the largest over the checked requests of
``||S(y) - S(r)|| / ||S(r)||`` over the band above the LR input's
(the upper two thirds of the bins, which the generator makes), y the
served waveform, r the reference's and S the normalised
(arcsinh-compressed) MDCT spectrum of the whole waveform by the
reference's transform: the compression undoes the sinh that magnifies the
generator's error on the way out, which would make a waveform's own
relative error ride a few loud requests.
"""

from __future__ import annotations

import math
import statistics
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch

STILL = 1e-3  # the share of the median leaf's gradient under which a leaf is still


def relative_gap(p: float, r: float) -> float:
    return abs(p - r) / abs(r)


def loss_gap(program: Sequence[Mapping[str, float]], reference: Sequence[Mapping[str, float]],
             keys: Iterable[str] = ("loss_G", "loss_D"), steps: int = 3) -> float:
    """The largest relative gap of the ``keys`` losses over the first
    ``steps`` steps (read by ``calibrate.py``, not compared)."""
    return max(relative_gap(p[k], r[k]) for p, r in zip(program[:steps], reference[:steps])
               for k in keys)


def _by_net(norms: Mapping[str, float]) -> Dict[str, Dict[str, float]]:
    nets: Dict[str, Dict[str, float]] = {}
    for k, v in norms.items():
        nets.setdefault(k.split(".", 1)[0], {})[k] = v
    return nets


def moving_leaves(ref_grads: Mapping[str, float], share: float = STILL) -> set:
    keep = set()
    for leaves in _by_net(ref_grads).values():
        med = statistics.median(leaves.values())
        keep |= {k for k, v in leaves.items() if v >= share * med}
    return keep


def leaf_gaps(program: Mapping[str, float], reference: Mapping[str, float],
              keep: Optional[set] = None) -> List[float]:
    """Each kept leaf's gap of norms, over the reference's norm of that
    leaf or of its network's median leaf, whichever is larger."""
    gaps = []
    for leaves in _by_net({k: v for k, v in reference.items()
                           if keep is None or k in keep}).values():
        med = statistics.median(leaves.values())
        gaps += [abs(program[k] - r) / max(r, med) for k, r in leaves.items()]
    return gaps


def p90(values: Sequence[float]) -> float:
    return statistics.quantiles(values, n=20)[17]


def bn_gap(program: Mapping[str, np.ndarray], reference: Mapping[str, np.ndarray],
           start: Mapping[str, np.ndarray], momentum: float = 0.1) -> float:
    """The worst running statistic's gap after one step, over the
    reference's move (``bn_gap`` above)."""
    worst = 0.0
    for k, r in reference.items():
        r = np.asarray(r, np.float64)
        move = np.linalg.norm(r - (1.0 - momentum) * np.asarray(start[k], np.float64))
        worst = max(worst, float(np.linalg.norm(np.asarray(program[k], np.float64) - r) / move))
    return worst


def add_norms(out: Dict) -> None:
    """Each leaf's norm of ``grads`` and of ``changes``, beside them."""
    out["grad_norms"] = {k: float(v.norm()) for k, v in out["grads"].items()}
    out["change_norms"] = {k: float(v.norm()) for k, v in out["changes"].items()}


def leaf_sums(program: Mapping, reference: Mapping, keep: Iterable[str],
              along: Optional[Mapping] = None) -> Dict[str, tuple]:
    """For each leaf of ``keep``, on the reference's device: ``||p - r||``,
    ``||r||`` and, with ``along`` (a gradient), ``<g, p>`` and ``<g, r>``."""
    out = {}
    with torch.no_grad():
        for k in keep:
            r = reference[k]
            p = program[k].to(r.device, r.dtype)
            row = (float((p - r).norm()), float(r.norm()))
            if along is not None:
                g = along[k].to(r.device, r.dtype)
                row += (float((g * p).sum()), float((g * r).sum()))
            out[k] = row
    return out


def net_gaps(sums: Mapping[str, tuple]) -> Dict[str, float]:
    """Per network: ``||p - r|| / ||r||`` over its leaves taken together."""
    acc: Dict[str, List[float]] = {}
    for k, (d, r, *_) in sums.items():
        a = acc.setdefault(k.split(".", 1)[0], [0.0, 0.0])
        a[0] += d * d
        a[1] += r * r
    return {net: math.sqrt(d / r) for net, (d, r) in acc.items()}


def descent_gaps(sums: Mapping[str, tuple]) -> Dict[str, float]:
    """Per network: ``1 - <g, p> / <g, r>`` summed over its leaves, the
    share of the reference's first-order descent along ``g`` that the
    program's change misses (2 and more where it climbs)."""
    acc: Dict[str, List[float]] = {}
    for k, (_, _, gp, gr) in sums.items():
        a = acc.setdefault(k.split(".", 1)[0], [0.0, 0.0])
        a[0] += gp
        a[1] += gr
    return {net: 1.0 - gp / gr for net, (gp, gr) in acc.items()}


def direction_gaps(program: Mapping, reference: Mapping) -> Dict[str, float]:
    """The direction numbers of both networks: the first gradient's and
    the change's gap of vectors (``net_gaps``) and the change's descent
    along the reference's first gradient (``descent_gaps``), over the
    moving leaves."""
    moving = sorted(moving_leaves(reference["grad_norms"]))
    grads = leaf_sums(program["grads"], reference["grads"], moving)
    changes = leaf_sums(program["changes"], reference["changes"], moving,
                        along=reference["grads"])
    out = {}
    for name, values in (("grad_dir", net_gaps(grads)), ("change_dir", net_gaps(changes)),
                         ("descent", descent_gaps(changes))):
        out.update({f"{name}.{net}": v for net, v in values.items()})
    return out


def first_loss_gap(program: Sequence[Mapping[str, float]],
                   reference: Sequence[Mapping[str, float]]) -> float:
    """The first step's worst relative gap over the six losses."""
    return max(relative_gap(program[0][k], r) for k, r in reference[0].items())


def train_numbers(program: Mapping, reference: Mapping,
                  start_bn: Mapping[str, np.ndarray]) -> Dict[str, float]:
    """Each of ``program`` and ``reference`` holds ``losses`` (per step),
    ``grads`` and ``changes`` (per leaf, with their norms) and ``bn_stats``
    (G's running statistics after step 1); ``start_bn`` holds them before
    it."""
    moving = moving_leaves(reference["grad_norms"])
    directions = direction_gaps(program, reference)
    return {
        "bn_gap": bn_gap(program["bn_stats"], reference["bn_stats"], start_bn),
        "change_gap": max(leaf_gaps(program["change_norms"], reference["change_norms"], moving)),
        "first_loss_gap": first_loss_gap(program["losses"], reference["losses"]),
        "grad_dir.D": directions["grad_dir.D"],
        "descent.D": directions["descent.D"],
    }


def diagnostics(program: Mapping, reference: Mapping) -> Dict[str, float]:
    """Numbers read by ``calibrate.py`` and not compared: the first step's
    losses one by one, the 90th percentile leaf's gap of the first
    gradient's norm and the direction numbers of both networks."""
    first, ref = program["losses"][0], reference["losses"][0]
    return {
        "loss_gap": loss_gap(program["losses"], reference["losses"]),
        **{f"{k}_gap": relative_gap(first[k], ref[k]) for k in ref},
        "grad_gap": p90(leaf_gaps(program["grad_norms"], reference["grad_norms"],
                                  moving_leaves(reference["grad_norms"]))),
        **direction_gaps(program, reference),
    }


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def serve_numbers(served: Sequence[np.ndarray], reference: Sequence[np.ndarray],
                  spectrum: Callable[[np.ndarray], np.ndarray]) -> Dict[str, float]:
    """``spectral_gap`` over the requests; ``spectrum`` takes a waveform to
    its normalised spectrum (the reference's transform)."""
    worst = 0.0
    for y, r in zip(served, reference):
        if y.shape != r.shape:
            return {"spectral_gap": math.inf}
        sy, sr = spectrum(y), spectrum(r)
        cut = sy.shape[-1] // 3
        worst = max(worst, _rel(sy[..., cut:], sr[..., cut:]))
    return {"spectral_gap": worst}


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]):
    """(correct, {name: {"value", "limit"}}): every limited number present,
    finite and at or under its limit."""
    table = {k: {"value": numbers.get(k, math.nan), "limit": lim} for k, lim in limits.items()}
    ok = bool(limits) and all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                              for v in table.values())
    return ok, table
