"""The traffic generator: draws repeat byte for byte from a seed, every
seed deals the same deck of sizes, and the mix's shape holds."""

import numpy as np
import pytest

from port_bench import spec
from port_bench.traffic import DECK, Traffic, length_at

BIG_SEED = 2**31 + 987654321  # more than 32 signed bits hold


def mix(name):
    return spec.read_json(spec.PKG / "traffic" / f"{name}.json")


def stream(t: Traffic, n: int):
    return [t.request(c, j) for j in range(n) for c in range(t.clients)]


def test_a_seed_repeats_its_requests_byte_for_byte():
    a, b = (Traffic(mix("chat"), 32768, 256, BIG_SEED) for _ in range(2))
    for ra, rb in zip(stream(a, 3), stream(b, 3)):
        assert ra.prompt.tobytes() == rb.prompt.tobytes()
        assert (ra.max_new, ra.index) == (rb.max_new, rb.index)


def test_every_seed_deals_the_same_sizes_in_the_same_order():
    def sizes(seed):
        t = Traffic(mix("chat"), 32768, 64, seed)
        return [(len(r.prompt), r.max_new) for r in stream(t, 9)]

    assert sizes(1) == sizes(BIG_SEED)
    a, b = Traffic(mix("chat"), 32768, 256, 1), Traffic(mix("chat"), 32768, 256, BIG_SEED)
    assert a.request(3, 2).prompt.tobytes() != b.request(3, 2).prompt.tobytes()
    one = [(len(r.prompt), r.max_new) for r in stream(a, 1)]
    assert sorted(one) == sorted(a.deck)  # a pass is the whole deck
    assert one != [(len(r.prompt), r.max_new) for r in stream(a, 2)][256:]  # passes rotate


def test_chat_lengths_follow_the_mix():
    t = Traffic(mix("chat"), 32768, 256, 7)
    lens = [n for n, _ in t.deck]
    outs = [o for _, o in t.deck]
    assert len(t.deck) == DECK and t.clients == 256
    assert min(lens) >= 32 and max(lens) <= 2048 and min(outs) >= 16 and max(outs) <= 512
    # the medians of the source (Splitwise's Azure conversation trace): 1,020 and 129
    assert np.median(lens) == 1020 and np.median(outs) == 129
    assert max(lens) + max(outs) <= 2560  # a request fits one slot of the engine
    for r in stream(t, 1):
        assert r.prompt.dtype == np.int32 and r.prompt.min() >= 1 and r.prompt.max() < 32768


def test_length_quantiles():
    d = {"dist": "lognormal", "median": 100, "sigma": 1.0, "min": 10, "max": 1000}
    assert length_at(d, 0.5) == 100
    assert length_at(d, 1e-9) == 10 and length_at(d, 1 - 1e-9) == 1000
    with pytest.raises(ValueError):
        length_at({"dist": "uniform", "min": 1, "max": 7}, 0.3)
