"""The generator's traffic is a function of the seed alone, and every
seed gets the same work in another order."""
import pytest

from benchmark.harness import gen, spec


def _mix(name):
    return spec.load_json(spec.BENCH_DIR / "traffic" / f"{name}.json")


def test_embed_requests_repeat_under_a_seed():
    t = _mix("ingest-docs")
    grid, words = gen.length_grid(t["tokens"]), gen.vocabulary(2000)
    a = [gen.embed_request(t, grid, words, 2**31 + 5, c, n)
         for c in range(3) for n in range(40)]
    b = [gen.embed_request(t, grid, words, 2**31 + 5, c, n)
         for c in range(3) for n in range(40)]
    other = [gen.embed_request(t, grid, words, 2**31 + 6, c, n)
             for c in range(3) for n in range(40)]
    assert a == b
    assert a != other


def test_every_seed_draws_each_stratum_once_a_round():
    t = _mix("ingest-docs")
    strata, per = t["tokens"]["strata"], gen.GRID // t["tokens"]["strata"]
    for seed in (1, 2**31 + 99, 3 * 10**9):
        for client in (0, 5):
            for rnd in range(3):
                got = sorted(gen.length_index(t, seed, client,
                                              rnd * strata + j) // per
                             for j in range(strata))
                assert got == list(range(strata))


def test_every_seed_sends_the_same_lengths_a_round():
    t = _mix("ingest-docs")
    strata = t["tokens"]["strata"]

    def rounds(seed):
        return [sorted(gen.length_index(t, seed, 3, r * strata + j)
                       for j in range(strata)) for r in range(5)]

    assert rounds(1) == rounds(2**31 + 5) == rounds(4 * 10**9)
    order = [gen.length_index(t, s, 3, j) for s in (1, 2) for j in range(16)]
    assert order[:16] != order[16:]


def test_lengths_and_texts_agree_and_stay_in_bounds():
    for name in ("ingest-docs", "ingest-chunks"):
        t = _mix(name)
        grid, words = gen.length_grid(t["tokens"]), gen.vocabulary(3000)
        assert grid.min() >= t["tokens"]["min"] and grid.max() <= t["tokens"]["max"]
        for n in range(50):
            ntok, text = gen.embed_request(t, grid, words, 7, 3, n)
            assert len(text.split()) == ntok - 2


@pytest.mark.parametrize("name", ["ingest-docs", "ingest-chunks"])
def test_unclipped_lengths_keep_the_published_mean(name):
    t = _mix(name)
    tokens = dict(t["tokens"], min=0, max=10**9)
    words = gen.length_grid(tokens) - 2
    assert abs(words.mean() / t["tokens"]["mean_words"] - 1) < 0.01
    assert str(t["tokens"]["mean_words"]) in t["source"]


def test_vocabulary_is_fixed():
    assert list(gen.vocabulary(50)) == list(gen.vocabulary(50))
    assert len(set(gen.vocabulary(5000))) == 5000
