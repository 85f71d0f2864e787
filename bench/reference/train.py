"""The reference of the training steps: the reference loss, its gradient
by autograd, and AdamW with a cosine schedule and clipping, in fp32, as
the traffic file states them (``optimizer``): b1, b2, eps, weight decay
on leaves of two or more dims (as the program's tree stacks them), a
clip of the global norm, a linear warm-up to the peak, then a cosine to
``floor`` times the peak at ``total`` steps."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from bench import weights as W


def lr_at(o: dict, step: int) -> float:
    if step < o["warmup"]:
        return o["peak_lr"] * (step + 1) / max(1, o["warmup"])
    t = min(max((step - o["warmup"]) / max(1, o["total"] - o["warmup"]),
                0.0), 1.0)
    return o["peak_lr"] * (o["floor"] + (1 - o["floor"]) * 0.5
                           * (1 + math.cos(math.pi * t)))


def _params(leaves, seed, device):
    """(tree for a model module's ``loss``, [(leaf, layer, tensor)] in a
    fixed order)."""
    tree: Dict = {}
    flat = []
    for leaf in leaves:
        for i in (range(leaf.layers) if leaf.layers is not None else [None]):
            t = W.draw(seed, leaf, i, device).requires_grad_(True)
            flat.append((leaf, i, t))
            if i is None:
                tree[leaf.path[0]] = t
                continue
            node = tree.setdefault((leaf.path[0], i), {})
            for k in leaf.path[1:-1]:
                node = node.setdefault(k, {})
            node[leaf.path[-1]] = t
    return tree, flat


def _norms(flat, values) -> Dict[str, float]:
    sq: Dict[str, float] = {}
    for (leaf, _, _), v in zip(flat, values):
        sq[leaf.name] = sq.get(leaf.name, 0.0) + float(v.double().square()
                                                       .sum())
    return {k: math.sqrt(v) for k, v in sq.items()}


def run_steps(ref, leaves, m: dict, opt: dict, seed: int,
              batches: List[dict], prec, device, fault=None) -> dict:
    """The reference's steps over ``batches`` (numpy "tokens", "labels"),
    the loss the model module ``ref``'s over the weights of ``leaves``:
    {"losses": [...], "grad": {leaf: norm of the first step's clipped
    gradient}, "change": {leaf: norm of the parameters' change after
    every step}}. ``fault`` plants one of the faults the check must catch
    ("half_batch": the loss of the first half of each batch's rows)."""
    tree, flat = _params(leaves, seed, device)
    mom = [torch.zeros_like(t) for _, _, t in flat]
    vel = [torch.zeros_like(t) for _, _, t in flat]
    losses, grad1 = [], None
    for step, b in enumerate(batches):
        tok = torch.as_tensor(b["tokens"], device=device)
        lab = torch.as_tensor(b["labels"], device=device)
        if fault == "half_batch":
            tok, lab = tok[: tok.shape[0] // 2], lab[: lab.shape[0] // 2]
        loss = ref.loss(m, tree, tok, lab, prec)
        grads = torch.autograd.grad(loss, [t for _, _, t in flat])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            gnorm = math.sqrt(sum(float(g.double().square().sum())
                                  for g in grads))
            scale = min(1.0, opt["clip"] / max(gnorm, 1e-9))
            for g in grads:
                g.mul_(scale)
            if step == 0:
                grad1 = _norms(flat, grads)
            t = step + 1
            bc1, bc2 = 1 - opt["b1"] ** t, 1 - opt["b2"] ** t
            lr = lr_at(opt, step)
            for (leaf, _, p), g, mo, ve in zip(flat, grads, mom, vel):
                mo.mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                ve.mul_(opt["b2"]).add_((1 - opt["b2"]) * g.square())
                u = (mo / bc1) / (torch.sqrt(ve / bc2) + opt["eps"])
                wd = opt["weight_decay"] if leaf.stacked_ndim >= 2 else 0.0
                p.sub_(lr * (u + wd * p))
        del grads
    with torch.no_grad():
        del mom, vel
        change = _norms(flat, (t.detach() - W.draw(seed, leaf, i, device)
                               for leaf, i, t in flat))
    return {"losses": losses, "grad": grad1, "change": change}
