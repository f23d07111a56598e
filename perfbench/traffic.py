"""The one traffic generator: requests from a mix's parameters.

A mix file (``mixes/<name>.json``) names its driver and gives the numbers
this module reads.  Lengths are drawn from ``{"dist": "lognormal",
"median", "sigma", "min", "max"}`` (clipped, rounded).  The set of request
sizes comes from the mix's own ``size_seed``, the same for every run; the
run's seed orders them and draws the prompts' token ids, so every seed
gives the engine the same work in another order.
"""
from __future__ import annotations

import numpy as np


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def requests(mix: dict, seed: int, vocab: int, n: int | None = None) -> list:
    """[(prompt token ids, new tokens)] of the mix's backlog (or its first n)."""
    total = mix["backlog"]
    sizes = np.random.default_rng(mix["size_seed"])
    prompt, new = lengths(mix["prompt_len"], total, sizes), lengths(mix["new_tokens"], total, sizes)
    rng = np.random.default_rng(seed)
    order = rng.permutation(total)[:n or total]
    return [(rng.integers(0, vocab, int(prompt[i])).tolist(), int(new[i])) for i in order]
