"""The one generator of traffic: requests and batches from a mix's
parameters and the run's seed.

A serving mix is an open loop: requests arrive on a schedule, whether or
not the earlier ones have finished.  A request is one prompt of a length
drawn from a log-normal distribution (``prompt_len``: its ``median`` and
``sigma``, cut to [``min``, ``max``]), answered with ``gen`` greedy
tokens.  The gaps between arrivals follow a Gamma distribution
(``arrivals``: its ``shape``; a shape under 1 gives bursts) whose mean is
1 / ``rate`` requests a second.

Every seed gets the same work in another order.  The requests come in
rounds of ``strata`` requests.  A round holds one length from each of
``strata`` equally likely strata of the length distribution (the
stratum's middle quantile), and likewise one gap from each stratum of
the gap distribution, in two orders drawn from the seed and the round.
So the lengths and gaps are a stratified sample of the distributions,
and a window that completes some rounds of requests does the same work
on any seed.  Prompt tokens are uniform over the vocabulary, drawn from
the seed and the request's index.  Warm-up requests take the shortest
and the longest length, with tokens of their own.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

WARMUP_STREAM = 1 << 40


def _middles(k: int) -> List[float]:
    return [(j + 0.5) / k for j in range(k)]


def lengths(mix: Dict) -> List[int]:
    """The prompt lengths of a round, ascending: the middle quantiles of
    the log-normal cut to [min, max]."""
    p, k = mix["prompt_len"], mix["strata"]
    z = NormalDist()
    mu, sigma = math.log(p["median"]), p["sigma"]
    lo, hi = (z.cdf((math.log(x) - mu) / sigma) for x in (p["min"],
                                                           p["max"]))
    return [round(math.exp(mu + sigma * z.inv_cdf(lo + (hi - lo) * u)))
            for u in _middles(k)]


def gaps(mix: Dict) -> List[float]:
    """The gaps between arrivals of a round, in seconds, ascending: the
    middle quantiles of the Gamma distribution, scaled so that their
    mean is exactly 1 / rate."""
    from scipy.special import gammaincinv
    a = mix["arrivals"]
    q = [float(gammaincinv(a["shape"], u)) for u in _middles(mix["strata"])]
    mean = sum(q) / len(q)
    return [x / (mean * a["rate"]) for x in q]


def request(mix: Dict, seed: int, i: int, table=None) -> Tuple[int, float]:
    """Request ``i``'s prompt length and the gap before its arrival.
    ``table``: ``(lengths(mix), gaps(mix))``, where the caller keeps
    them."""
    lens, gs = table or (lengths(mix), gaps(mix))
    k = len(lens)
    rng = np.random.default_rng([seed, i // k])
    by_len, by_gap = rng.permutation(k), rng.permutation(k)
    return lens[by_len[i % k]], gs[by_gap[i % k]]


def prompts(vocab: int, seed: int, i: int, length: int) -> np.ndarray:
    """(1, length) int32 prompt tokens of request ``i``."""
    rng = np.random.default_rng([seed, 1, i])
    return rng.integers(0, vocab, (1, length), dtype=np.int32)


def warmup(mix: Dict, vocab: int, seed: int) -> List[np.ndarray]:
    lens = lengths(mix)
    return [prompts(vocab, seed, WARMUP_STREAM + j, n)
            for j, n in enumerate(sorted({lens[0], lens[-1]}))]


def corpus(seed: int, vocab: int, shards: int, shard_tokens: int
           ) -> List[np.ndarray]:
    """A training corpus: ``shards`` arrays of int32 tokens, uniform over
    the vocabulary."""
    rng = np.random.default_rng([seed, 2])
    return [rng.integers(0, vocab, shard_tokens, dtype=np.int32)
            for _ in range(shards)]
