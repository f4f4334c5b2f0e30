"""The traffic generator repeats from a seed, and every seed asks for the
same work in another order."""
import collections

import pytest
import torch

from chipbench import gen

CHAT = {"round": 64, "sample": 12,
        "lengths": {"dist": "lognormal", "median": 1024, "sigma": 1.0,
                    "min": 128, "max": 8192, "multiple": 128}}
DOCS = {"round": 16, "sample": 8,
        "lengths": {"dist": "choice", "values": [512, 1024, 2048, 4096]}}
BIG_SEED = 2**31 + 977


def test_lognormal_round_is_fixed_and_on_the_kernel_grid():
    lens = gen.round_lengths(CHAT["lengths"], 64)
    assert lens == sorted(lens) and len(lens) == 64
    assert all(L % 128 == 0 and 128 <= L <= 8192 for L in lens)
    assert lens[32] == 1152            # the median, on its 128-token step
    assert lens[-1] == 8192 and lens[0] == 128


def test_choice_round_takes_each_value_equally_often():
    assert collections.Counter(gen.round_lengths(DOCS["lengths"], 16)) == \
        {512: 4, 1024: 4, 2048: 4, 4096: 4}
    with pytest.raises(ValueError):
        gen.round_lengths(DOCS["lengths"], 6)


@pytest.mark.parametrize("traffic", [CHAT, DOCS])
def test_a_seed_repeats_and_seeds_differ_only_in_order(traffic):
    a = gen.Prompts(traffic, BIG_SEED, 256, "cpu")
    b = gen.Prompts(traffic, BIG_SEED, 256, "cpu")
    c = gen.Prompts(traffic, 12345, 256, "cpu")
    n = 3 * traffic["round"]
    for p in (a, b, c):
        p.ensure(n)
    assert a.lengths[:n] == b.lengths[:n]
    assert all(torch.equal(a.tokens(i), b.tokens(i)) for i in range(n))
    assert a.sample(n) == b.sample(n)
    assert a.lengths[:n] != c.lengths[:n]
    for r in range(3):
        s = slice(r * traffic["round"], (r + 1) * traffic["round"])
        assert sorted(a.lengths[s]) == sorted(c.lengths[s]) == a.base
    assert all(a.tokens(i).shape == (1, a.lengths[i]) and
               a.tokens(i).dtype == torch.int32 for i in range(n))
    assert all(0 <= i < n for i in a.sample(n))
    assert len(a.sample(n)) == traffic["sample"]


@pytest.mark.parametrize("traffic", [CHAT, DOCS])
def test_the_sample_is_drawn_from_every_finished_round(traffic):
    """A run that finished more requests checks a draw over all of them:
    the requests it shares with a shorter run's draw are those of that
    draw that are still among the least."""
    p = gen.Prompts(traffic, BIG_SEED, 256, "cpu")
    R = traffic["round"]
    big = p.sample(12 * R)
    assert {i // R for i in big} != {0}
    for n in (R, 3 * R + 5, 12 * R):
        small = set(p.sample(n))
        assert {i for i in big if i < n} <= small
    counts = collections.Counter(i // R for s in range(40) for i in
                                 gen.Prompts(traffic, s, 256, "cpu")
                                 .sample(4 * R))
    assert set(counts) == {0, 1, 2, 3}
