"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and a seed in, a list of requests (and, in an open loop, their due times)
out.

Every seed gets the same work.  The sizes (prefix group, prompt and
output lengths, adapter, greedy or sampled) and the gaps between arrivals
are drawn once from the mix's own ``size_seed``; the run's seed draws the
token ids and, unless the mix says ``"order": "fixed"``, permutes the
requests and the gaps.  So two seeds differ in what the requests say (and
perhaps in which comes when), never in how much there is to do.  A fixed
order keeps an open loop's bursts where they are: which long prompts
arrive together otherwise moves its tails more than the host does.

Mix keys:

- ``loop``: ``"open"`` (``rate_rps``: Poisson arrivals, exactly
  ``round(rate_rps * seconds)`` requests due inside the window) or
  ``"closed"`` (``clients``, each sending its next request when the last
  one finished, from a shared queue of ``pool`` requests; the first
  request of each client has its output cut by a fixed factor in (0, 1]
  so the clients do not finish in step; ``ramp_s``: the clients start
  that long before the window, so it opens on a loop in its steady state,
  and the ramp counts as set-up);
- ``prefixes``: ``count`` shared prefixes of ``tokens`` tokens with
  Zipf(``zipf``) popularity (``count`` 0: no shared prefix);
- ``suffix`` / ``output``: lognormal lengths, ``median`` and ``sigma`` of
  the underlying normal, clipped to ``[min, max]``;
- ``adapters``: ``count`` adapters of rank ``rank``; ``per_prefix``
  prefixes per adapter (a tenant owns its prefixes) or, without it, an
  equal share each; ``base_share`` of the requests use the base model;
- ``greedy_share``; the rest sample at ``temperature`` / ``top_p`` with a
  seed of their own;
- ``warmup``: ``requests`` drawn from the same distributions (another
  stream of the run's seed) whose outputs stop at ``max_new_tokens``;
- ``drain_s``: how long past the window the run waits for the window's
  requests before it counts the rest as failed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class Planned:
    """One request as the traffic defines it."""
    index: int
    prefix: int            # shared prefix group, -1 for none
    prompt: list           # token ids
    max_new_tokens: int
    adapter: int           # adapter index, -1 for the base model
    greedy: bool
    sample_seed: int
    due: float = 0.0       # seconds after the window's start (open loop)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def _lognormal(rng, spec: dict, n: int) -> np.ndarray:
    x = rng.lognormal(math.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def _sizes(mix: dict, n: int) -> dict:
    """The fixed multiset of sizes: n of each, from ``size_seed``."""
    rng = _rng(mix["size_seed"], 0)
    pre = mix.get("prefixes", {"count": 0})
    if pre["count"]:
        ranks = np.arange(1, pre["count"] + 1, dtype=np.float64)
        p = ranks ** -float(pre.get("zipf", 0.0))
        prefix = rng.choice(pre["count"], size=n, p=p / p.sum())
    else:
        prefix = np.full(n, -1)
    ad = mix.get("adapters", {"count": 0})
    base = rng.random(n) < ad.get("base_share", 1.0 if not ad["count"] else 0)
    if ad["count"] and ad.get("per_prefix"):
        adapter = prefix // ad["per_prefix"]
    elif ad["count"]:
        adapter = rng.integers(0, ad["count"], n)
    else:
        adapter = np.full(n, -1)
    adapter = np.where(base, -1, adapter)
    return {
        "prefix": prefix,
        "suffix": _lognormal(rng, mix["suffix"], n),
        "output": _lognormal(rng, mix["output"], n),
        "adapter": adapter,
        "greedy": rng.random(n) < mix.get("greedy_share", 1.0),
        "gaps": rng.exponential(1.0, n),
        "first_cut": rng.uniform(0.05, 1.0, n),
    }


def request_count(mix: dict, seconds: float) -> int:
    """Requests one run draws: due in the window (open loop) or the
    closed loop's queue."""
    if mix["loop"] == "open":
        return max(1, round(mix["rate_rps"] * seconds))
    return int(mix["pool"])


def prefix_tokens(mix: dict, seed: int, vocab: int) -> np.ndarray:
    """The shared prefixes' token ids, [count, tokens], from the run's
    seed."""
    pre = mix.get("prefixes", {"count": 0})
    return _rng(seed, 1).integers(0, vocab, (pre["count"], pre.get("tokens", 0)))


def _build(mix: dict, seed: int, vocab: int, sizes: dict, order,
           stream: int) -> list:
    prefixes = prefix_tokens(mix, seed, vocab)
    rng = _rng(seed, stream)
    out = []
    for j, i in enumerate(order):
        g = int(sizes["prefix"][i])
        head = prefixes[g].tolist() if g >= 0 else []
        tail = rng.integers(0, vocab, int(sizes["suffix"][i])).tolist()
        out.append(Planned(
            index=j, prefix=g, prompt=head + tail,
            max_new_tokens=int(sizes["output"][i]),
            adapter=int(sizes["adapter"][i]),
            greedy=bool(sizes["greedy"][i]),
            sample_seed=int(rng.integers(0, 2**31 - 1))))
    return out


def requests(mix: dict, seed: int, seconds: float, vocab: int) -> list:
    """The run's requests in the order they are sent.  Open loop: each
    with its ``due`` time in [0, seconds)."""
    n = request_count(mix, seconds)
    sizes = _sizes(mix, n)
    rng = _rng(seed, 2)
    if mix.get("order") == "fixed":
        perm = np.arange(n)
    elif mix["loop"] == "open":
        perm = rng.permutation(n)
    else:
        # The first wave (one request a client, outputs cut) is the same
        # set for every seed, and so is the rest.
        clients = min(n, int(mix["clients"]))
        lo = mix["output"]["min"]
        sizes["output"][:clients] = np.maximum(
            lo, np.rint(sizes["output"][:clients]
                        * sizes["first_cut"][:clients])).astype(np.int64)
        perm = np.concatenate([rng.permutation(clients),
                               clients + rng.permutation(n - clients)])
    reqs = _build(mix, seed, vocab, sizes, perm, 3)
    if mix["loop"] == "open":
        gaps = sizes["gaps"]
        if mix.get("order") != "fixed":
            gaps = gaps[_rng(seed, 4).permutation(n)]
        # Request i is due after the gaps before it; the n gaps fill the
        # window exactly, the last one running to its end.
        due = (np.cumsum(gaps) - gaps) / gaps.sum() * seconds
        for r, t in zip(reqs, due):
            r.due = float(t)
    return reqs


def warmup_requests(mix: dict, seed: int, vocab: int) -> list:
    """The warm-up's requests: the mix's own shapes, another stream of the
    seed, outputs capped."""
    w = mix.get("warmup", {"requests": 0})
    n = int(w["requests"])
    if not n:
        return []
    sizes = _sizes(dict(mix, size_seed=mix["size_seed"] + 1), n)
    reqs = _build(mix, seed, vocab, sizes, range(n), 5)
    for r in reqs:
        r.max_new_tokens = min(r.max_new_tokens, int(w["max_new_tokens"]))
    return reqs
