"""The traffic generator: seeded, the same work for every seed, and the
stated distributions."""
import math
from collections import Counter

import numpy as np

from benchmark import generator
from benchmark.tests import tiny

MIX = dict(tiny.CHAT, rate_rps=50.0)


def _key(r):
    return (r.prefix, len(r.prompt), r.max_new_tokens, r.adapter, r.greedy)


def test_same_seed_same_requests():
    a = generator.requests(MIX, 123, 20, 320)
    b = generator.requests(MIX, 123, 20, 320)
    assert [(r.prompt, r.max_new_tokens, r.due) for r in a] == \
        [(r.prompt, r.max_new_tokens, r.due) for r in b]


def test_seeds_share_the_work_in_another_order():
    big = 2**31 + 12345
    a = generator.requests(MIX, 1, 20, 320)
    b = generator.requests(MIX, big, 20, 320)
    assert Counter(map(_key, a)) == Counter(map(_key, b))
    assert [r.prompt for r in a] != [r.prompt for r in b]
    gaps = [sorted(np.diff([r.due for r in x] + [20.0]).round(9))
            for x in (a, b)]
    assert gaps[0] == gaps[1]


def test_open_loop_count_and_dues():
    reqs = generator.requests(MIX, 5, 20, 320)
    assert len(reqs) == round(MIX["rate_rps"] * 20)
    dues = [r.due for r in reqs]
    assert dues == sorted(dues) and dues[0] == 0 and dues[-1] < 20


def test_lengths_follow_the_mix():
    mix = dict(MIX, rate_rps=1000.0)
    reqs = generator.requests(mix, 9, 20, 320)
    out = np.array([r.max_new_tokens for r in reqs])
    suf = np.array([len(r.prompt) - (32 if r.prefix >= 0 else 0)
                    for r in reqs])
    for x, spec in ((out, mix["output"]), (suf, mix["suffix"])):
        assert x.min() >= spec["min"] and x.max() <= spec["max"]
        assert abs(math.log(np.median(x) / spec["median"])) < 0.1
    pops = Counter(r.prefix for r in reqs)
    assert pops[0] > pops[1] > pops[3]
    base = np.mean([r.adapter < 0 for r in reqs])
    assert abs(base - 0.2) < 0.02
    assert abs(np.mean([r.greedy for r in reqs]) - 0.5) < 0.02
    # A tenant owns its prefixes.
    assert all(r.adapter in (-1, r.prefix) for r in reqs)


def test_closed_loop_waves_are_the_same_work():
    mix = tiny.CLOSED
    a = generator.requests(mix, 3, 20, 320)
    b = generator.requests(mix, 2**33 + 1, 20, 320)
    c = mix["clients"]
    assert len(a) == mix["pool"] and all(r.prefix == 0 for r in a)
    assert Counter(map(_key, a[:c])) == Counter(map(_key, b[:c]))
    assert Counter(map(_key, a[c:])) == Counter(map(_key, b[c:]))


def test_warmup_is_capped_and_seeded():
    w = generator.warmup_requests(tiny.CHAT, 3, 320)
    assert len(w) == 4 and all(r.max_new_tokens <= 4 for r in w)
    assert [r.prompt for r in w] == \
        [r.prompt for r in generator.warmup_requests(tiny.CHAT, 3, 320)]


def test_fixed_order_keeps_the_schedule():
    mix = dict(MIX, order="fixed")
    a = generator.requests(mix, 1, 20, 320)
    b = generator.requests(mix, 2**40 + 3, 20, 320)
    assert [(_key(r), r.due) for r in a] == [(_key(r), r.due) for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in b]
