"""The generator: one seed, one schedule; every seed the same work in
another order; the clipping holds."""
import numpy as np
import pytest

from gpubench import spec
from gpubench.traffic import Generator, gaps, quantiles

CHAT = spec.load_traffic("chat")
BACKLOG = spec.load_traffic("backlog")


def schedule(mix, seed, block=40, rate=8.0, n=3):
    return Generator(mix, 151936, seed, block, rate).blocks(n)


def test_same_seed_same_schedule():
    a, b = schedule(CHAT, 2 ** 40 + 3), schedule(CHAT, 2 ** 40 + 3)
    assert [(r.due, r.prompt, r.max_new) for r in a] == [(r.due, r.prompt, r.max_new) for r in b]


def test_seeds_differ_in_order_alone():
    a, b = schedule(CHAT, 5), schedule(CHAT, 6)
    assert [r.prompt for r in a] != [r.prompt for r in b]
    for k in range(3):
        blk = slice(40 * k, 40 * (k + 1))
        assert sorted(len(r.prompt) for r in a[blk]) == sorted(len(r.prompt) for r in b[blk])
        assert sorted(r.max_new for r in a[blk]) == sorted(r.max_new for r in b[blk])
        ga = np.diff([0.0] + [r.due for r in a])[blk]
        gb = np.diff([0.0] + [r.due for r in b])[blk]
        np.testing.assert_allclose(np.sort(ga), np.sort(gb), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mix", [CHAT, BACKLOG], ids=["chat", "backlog"])
def test_clipping_and_fit(mix):
    for part in ("prompt", "output"):
        q = quantiles(mix[part], 500)
        assert q.min() >= mix[part]["min"] and q.max() <= mix[part]["max"]
        assert abs(np.median(q) - mix[part]["median"]) <= 0.02 * mix[part]["median"]
    longest = mix["prompt"]["max"] + mix["output"]["max"]
    assert longest <= mix["engine"]["max_len"]            # every request can be admitted


def test_token_ids_inside_the_vocabulary():
    reqs = Generator(CHAT, 1000, 9, 32, 4.0).blocks(2)
    ids = np.concatenate([r.prompt for r in reqs])
    assert ids.min() >= 0 and ids.max() < 1000


def test_block_lasts_its_share_of_the_rate():
    g = gaps(37, 9.5)
    assert g.sum() == pytest.approx(37 / 9.5, rel=1e-12)
    reqs = Generator(CHAT, 100, 1, 37, 9.5).blocks(2, t0=-1.0)
    assert reqs[36].due == pytest.approx(-1.0 + 37 / 9.5, rel=1e-12)
    assert reqs[-1].due == pytest.approx(-1.0 + 2 * 37 / 9.5, rel=1e-12)


def test_rotation_sends_one_cycle_from_another_start():
    """Under ``order: rotate`` every seed's block is the same sequence of
    (prompt length, output length, gap), rotated."""
    mix = dict(CHAT, order="rotate", base_seed=1)

    def cycle(seed):
        reqs = Generator(mix, 1000, seed, 50, 10.0).blocks(2)
        gap = np.diff([0.0] + [r.due for r in reqs])
        return [(len(r.prompt), r.max_new, round(g, 12)) for r, g in zip(reqs, gap)]

    a, b = cycle(101), cycle(202)
    assert a[:50] == a[50:]                          # the cycle repeats
    assert a[:50] != b[:50]
    shift = next(k for k in range(50) if a[k:50] + a[:k] == b[:50])
    assert 0 < shift < 50
