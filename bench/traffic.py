"""The one traffic generator: it reads a traffic file's parameters and
gives the units of work a run sends, from the run's seed.

A ``serve`` mix is one closed-loop client. Each unit is one call of the
serving loop: a batch of ``batch`` prompts of one length (the loop takes
a rectangular batch) and ``n_new`` tokens to generate. The lengths are a
fixed list, replayed in its order: ``lengths`` itself, or ``n`` draws
log-uniform in [lo, hi] from the file's own ``mix_seed``. So every seed
sends the same sizes in the same order, and a window's work does not
change with the seed; the run's seed draws the token ids, uniform over
the vocabulary. A window sends whole passes of the list
(``pass_units``), so a faster or slower program is timed on the same mix.

A ``train`` mix is batches of ``batch`` rows of ``seq`` tokens read from
a corpus of ``corpus_tokens`` uniform ids written from the seed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def lengths(t: dict) -> List[int]:
    """The mix's prompt lengths, in the file's order."""
    if "lengths" in t:
        return [int(x) for x in t["lengths"]]
    d = t["loguniform"]
    rng = np.random.default_rng(d["mix_seed"])
    u = rng.random(d["n"])
    lo, hi = np.log(d["lo"]), np.log(d["hi"])
    return [int(x) for x in np.floor(np.exp(lo + u * (hi - lo)))]


def pass_units(t: dict) -> int:
    """Units in one pass of a serve mix's list."""
    return len(lengths(t))


def unit(t: dict, seed: int, i: int, vocab: int) -> Dict:
    """The i-th unit of a serve mix: {"S0", "tokens" (batch, S0) int32,
    "n_new"}."""
    ls = lengths(t)
    S0 = ls[i % len(ls)]
    rng = np.random.default_rng([seed, 1, i])
    tokens = rng.integers(0, vocab, (t["batch"], S0), dtype=np.int32)
    return {"index": i, "S0": S0, "tokens": tokens, "n_new": t["n_new"]}


def corpus(t: dict, seed: int, vocab: int) -> np.ndarray:
    """A training corpus of ``corpus_tokens`` uniform int32 ids."""
    rng = np.random.default_rng([seed, 2])
    return rng.integers(0, vocab, t["corpus_tokens"], dtype=np.int32)
