"""How ``correct`` is decided: the program's outputs from the timed
window against the plain reference (``bench.reference``: the model
module the configuration names, ``ref`` below).

Serving: a sample of the generates the window finished, drawn from the
seed, with the longest among them. The reference runs once over each
prompt with its served tokens (teacher forcing, routing groups as the
program routes them), and each served token is read by how far its
reference logit lies below the reference's best at that position
(``logit_gap_max``, the widest, and ``logit_gap_mean``). The control
reads, at the same positions, the gap of the token that the reference
computed in fp8 puts first.

Training: the reference follows the first three steps from the same
weights and batches. Compared: each step's loss (``loss_gap``, relative),
the norm of each leaf's first gradient as the optimizer got it
(``grad_gap``) and of each leaf's change after the three steps
(``change_gap``), both at the worst leaf, as the gap of the two norms
over the larger of the reference's norm of that leaf and of the median
leaf. Leaves whose reference gradient is under a thousandth of the
median leaf's move by round-off alone under Adam and are left out of
both.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List

import numpy as np
import torch

from bench import weights as W
from bench.reference import train as ref_train
from bench.reference.common import Prec, gap_of

ZERO_GRAD = 1e-3         # of the median leaf's reference gradient


def sample_units(units: List[dict], k: int, seed: int) -> List[dict]:
    """Up to ``k`` finished units: the one with the longest prompt, and
    the rest drawn from the seed."""
    if len(units) <= k:
        return list(units)
    longest = max(range(len(units)), key=lambda i: units[i]["S0"])
    rest = [i for i in range(len(units)) if i != longest]
    pick = np.random.default_rng([seed, 4]).choice(len(rest), k - 1,
                                                   replace=False)
    return [units[longest]] + [units[rest[j]] for j in sorted(pick)]


def _layer_weights(spec, seed, device, dtype):
    leaves = {}
    for leaf in spec:
        if leaf.layers is not None:
            leaves.setdefault(leaf.path[0], []).append(leaf)

    def get(stack, i):
        tree: Dict = {}
        for leaf in leaves[stack]:
            node = tree
            for k in leaf.path[1:-1]:
                node = node.setdefault(k, {})
            node[leaf.path[-1]] = W.slice_as(seed, leaf, i, device, dtype)
        return tree
    return get


def serve_readings(ref, leaves, m: dict, seed: int, units: List[dict],
                   device, dtype=torch.bfloat16,
                   control: bool = False) -> Dict:
    """{"program": {...}, and with ``control`` "control": {...}} readings
    over ``units`` (each {"tokens" prompt (B, S0), "served" (B, n_new)}),
    the weights those of ``leaves``."""
    top = {leaf.path[0]: W.slice_as(seed, leaf, None, device, dtype)
           for leaf in leaves if leaf.layers is None}
    layer = _layer_weights(leaves, seed, device, dtype)
    jobs = []
    for u in units:
        served = torch.as_tensor(u["served"], device=device).long()
        prompt = torch.as_tensor(u["tokens"], device=device).long()
        S0, n = prompt.shape[1], served.shape[1]
        jobs.append({"tokens": torch.cat([prompt, served[:, :-1]], 1),
                     "S0": S0, "score": list(range(S0 - 1, S0 - 1 + n)),
                     "served": served})
    logits = ref.serve_logits(m, layer, top, jobs, Prec(), device)

    def reading(picked):
        """Gaps of the tokens ``picked`` at each scored position (a list
        of (B, n) per job): over all, the first token (the prefill's) and
        the decoded ones apart."""
        g = [gap_of(lg, p) for lg, p in zip(logits, picked)]
        every = torch.cat([x.reshape(-1) for x in g])
        out = {"logit_gap_max": float(every.max()),
               "logit_gap_mean": float(every.mean()),
               "tokens": int(every.numel())}
        first = torch.cat([x[:, 0] for x in g])
        out["first_gap_max"] = float(first.max())
        rest = [x[:, 1:].reshape(-1) for x in g if x.shape[1] > 1]
        if rest:
            out["decode_gap_mean"] = float(torch.cat(rest).mean())
        return out

    out = {"program": reading([j["served"] for j in jobs])}
    if control:
        # the control, and as a witness the reference in bf16: the tokens
        # each puts first, read against the fp32 reference
        for name, prec in (("control", Prec(fp8=True)),
                           ("bf16_reference", Prec(bf16=True))):
            low = ref.serve_logits(m, layer, top, jobs, prec, device)
            out[name] = reading([lo.argmax(-1) for lo in low])
    return out


def _worst(prog: Dict[str, float], want: Dict[str, float],
           leaves: List[str]) -> tuple:
    """(the worst leaf's gap, that leaf)."""
    med = float(np.median([want[k] for k in leaves]))
    return max((abs(prog[k] - want[k]) / max(want[k], med), k)
               for k in leaves)


def train_numbers(prog: dict, want: dict) -> Dict[str, float]:
    """The three numbers of a training run ``prog`` against ``want`` (each
    {"losses", "grad", "change"})."""
    med = float(np.median(list(want["grad"].values())))
    leaves = [k for k, v in want["grad"].items() if v >= ZERO_GRAD * med]
    grad, grad_leaf = _worst(prog["grad"], want["grad"], leaves)
    change, change_leaf = _worst(prog["change"], want["change"], leaves)
    print(f"worst leaves: gradient {grad_leaf}, change {change_leaf}; "
          f"left out as unmoved: {sorted(set(want['grad']) - set(leaves))}",
          file=sys.stderr)
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["losses"], want["losses"])),
        "grad_gap": grad, "change_gap": change,
    }


def train_readings(ref, leaves, m: dict, opt: dict, seed: int,
                   batches: List[dict], prog: dict, device,
                   control: bool = False, faults=()) -> Dict:
    """Readings of the program's first steps ``prog`` against the
    reference's; with ``control``, those of the reference in fp8 in its
    place; for each fault, those of the reference with it planted."""
    want = ref_train.run_steps(ref, leaves, m, opt, seed, batches, Prec(),
                               device)
    out = {"program": train_numbers(prog, want)}
    if control:
        low = ref_train.run_steps(ref, leaves, m, opt, seed, batches,
                                  Prec(fp8=True), device)
        out["control"] = train_numbers(low, want)
    for f in faults:
        bad = ref_train.run_steps(ref, leaves, m, opt, seed, batches,
                                  Prec(), device, fault=f)
        out[f] = train_numbers(bad, want)
    return out


def judge(numbers: Dict[str, float], limits: Dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) for the numbers ``limits``
    names; a number that is not finite fails."""
    checks, ok = {}, True
    for name, lim in limits["numbers"].items():
        v = numbers.get(name, float("nan"))
        checks[name] = {"value": v, "limit": lim["limit"]}
        ok = ok and math.isfinite(v) and v <= lim["limit"]
    return ok, checks
