"""Both generators give the same trace for the same seed and another
for another seed, with the same sizes in another order."""
import json

import numpy as np
import pytest

from h100_bench.bench import loadgen
from h100_bench.bench.common import ROOT, plugin

SESSIONS = plugin("traffic/kinds", "sessions")
TRAIN = plugin("traffic/kinds", "train_steps")


def schedule(traffic, seed, seconds, vocab=50257):
    return SESSIONS.schedule(traffic, seed, seconds, vocab)


def mix(name):
    return json.loads((ROOT / "h100_bench/traffic" / f"{name}.json")
                      .read_text())


def trace(requests):
    return [(r.due_s, r.prompt.tolist(), r.max_new) for r in requests]


def sizes(requests):
    return sorted((len(r.prompt), r.max_new) for r in requests)


def test_serving_trace_follows_the_seed():
    for name in ("chat-poisson", "docqa-shared"):
        t = mix(name)
        a = schedule(t, 2 ** 31 + 3, 20.0, 50257)
        b = schedule(t, 2 ** 31 + 3, 20.0, 50257)
        c = schedule(t, 2 ** 31 + 4, 20.0, 50257)
        assert trace(a) == trace(b)
        assert trace(a) != trace(c)
        # stratified draws: chat sends one set of requests in every order
        if name == "chat-poisson":
            assert sizes(a) == sizes(c)
        assert abs(len(a) - len(c)) <= 0.1 * len(a)
        assert all(r.due_s < 20.0 for r in a)
        loadgen.check_lengths(a, 1024)


def test_chat_mix_sizes_and_rate():
    t = mix("chat-poisson")
    reqs = schedule(t, 7, 30.0)
    assert len(reqs) == round(t["rate_rps"] * 30.0)
    lens = [len(r.prompt) for r in reqs]
    outs = [r.max_new for r in reqs]
    assert min(lens) >= 4 and max(lens) <= 512
    assert min(outs) >= 16 and max(outs) <= 512
    # the means of the source, less what the cut to 512 takes off
    assert 130 <= np.mean(lens) <= 161.31
    assert 230 <= np.mean(outs) <= 337.99
    assert all(r.greedy for r in reqs)
    # unshared: no two prompts begin alike
    heads = {tuple(r.prompt[:16]) for r in reqs}
    assert len(heads) == len(reqs)


def test_arrivals_take_one_set_of_gaps_in_a_seeded_order():
    poisson = plugin("traffic/arrivals", "poisson")
    a = np.diff(poisson.starts({}, 200, 4.0, 2 ** 31 + 5))
    b = np.diff(poisson.starts({}, 200, 4.0, 2 ** 31 + 6))
    assert not np.allclose(a, b)
    # each seed leaves out one gap of the set before its first start
    both = np.intersect1d(np.round(a, 12), np.round(b, 12))
    assert len(both) >= len(a) - 1
    assert abs(np.mean(a) - 0.25) <= 0.02
    t = mix("chat-poisson")
    due = [r.due_s for r in schedule(t, 3, 60.0)]
    assert due != [r.due_s for r in schedule(t, 4, 60.0)]
    assert abs(len(due) / 60.0 - t["rate_rps"]) <= 0.1 * t["rate_rps"]


def test_a_sampled_mix_sends_its_greedy_share():
    t = dict(mix("chat-poisson"), temperature=0.7, greedy_share=0.25)
    reqs = schedule(t, 9, 30.0)
    greedy = [r for r in reqs if r.greedy]
    assert len(greedy) == round(0.25 * len(reqs))
    assert all(r.temperature == 0.7 and r.rng is not None
               for r in reqs if not r.greedy)
    again = schedule(t, 9, 30.0)
    assert [r.rng for r in reqs] == [r.rng for r in again]


def test_an_unknown_arrival_process_is_refused():
    from h100_bench.bench.common import BenchError
    t = dict(mix("chat-poisson"), arrivals={"process": "no-such"})
    with pytest.raises(BenchError):
        schedule(t, 1, 5.0)


def test_docqa_asks_share_their_document():
    t = mix("docqa-shared")
    reqs = schedule(t, 11, 30.0, 50257)
    by_session = {}
    for r in reqs:
        by_session.setdefault(r.session, []).append(r)
    full = [s for s in by_session.values() if len(s) == t["asks"]]
    assert full
    for asks in full:
        doc = asks[0].prefix_len
        assert 512 <= doc <= 768
        first = asks[0].prompt[:doc]
        for r in asks[1:]:
            assert np.array_equal(r.prompt[:doc], first)
            assert r.due_s - asks[0].due_s <= 3 * t["ask_gap_s"]["max"]
        tails = {tuple(r.prompt[doc:]) for r in asks}
        assert len(tails) == len(asks)


def test_training_rows_follow_the_seed_and_the_step():
    t = {"kind": "train_steps", "batch": 4, "seq_len": 16}
    x1, y1 = TRAIN.batch(t, 5, 0, 50257)
    x2, _ = TRAIN.batch(t, 5, 0, 50257)
    x3, _ = TRAIN.batch(t, 5, 1, 50257)
    x4, _ = TRAIN.batch(t, 6, 0, 50257)
    assert np.array_equal(x1, x2)
    assert not np.array_equal(x1, x3) and not np.array_equal(x1, x4)
    assert np.array_equal(x1[:, 1:], y1[:, :-1])
    assert x1.min() >= 1 and x1.max() <= 50257
    assert len({tuple(r) for r in np.concatenate([x1, x3])}) == 8
