"""The general generator of in-flight serving rounds, from a traffic
mix's parameters.

Every round holds the same requests' shapes, whatever the seed: prompt
lengths, generation budgets and arrival ticks spread evenly over their
ranges (the mix's `prompt_len`, `gen`, `arrival`: [lo, hi], the
arrivals' hi exclusive), paired by one fixed shuffle.  The seed and the
round's index draw the token ids and the order of the uids, so no seed
changes how much work a round holds or how it is scheduled: pairings
that differ change a round's decode steps by a tenth.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


PAIRING = 20240101   # the one shuffle that pairs sizes with arrivals


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """n integers spread evenly over [lo, hi], both ends included."""
    if n == 1:
        return np.array([lo])
    return np.round(lo + (hi - lo) * np.arange(n) / (n - 1)).astype(int)


def make_round(mix: Dict, seed: int, index: int, vocab: int) -> List[Dict]:
    """One round's requests: {uid, prompt (np int array), gen, arrival},
    sorted by arrival (ties by uid)."""
    n = mix["requests"]
    fixed = np.random.default_rng(PAIRING)
    plen = fixed.permutation(spread(*mix["prompt_len"], n))
    gen = fixed.permutation(spread(*mix["gen"], n))
    lo, hi = mix["arrival"]
    arr = fixed.permutation(spread(lo, hi - 1, n))
    rng = np.random.default_rng([int(seed) & ((1 << 63) - 1), index])
    uids = index * n + rng.permutation(n)
    reqs = [{"uid": int(uids[u]),
             "prompt": rng.integers(0, vocab, size=int(plen[u])),
             "gen": int(gen[u]), "arrival": int(arr[u])}
            for u in range(n)]
    reqs.sort(key=lambda r: (r["arrival"], r["uid"]))
    return reqs


def max_len(mix: Dict) -> int:
    """The KV cache length a round needs: the longest prompt, the
    longest generation and 8 spare."""
    return mix["prompt_len"][1] + mix["gen"][1] + 8
