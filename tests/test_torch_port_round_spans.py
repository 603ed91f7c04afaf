"""The serving engine's round-level spans (``lm/round``,
``lm/token_pick``, ``lm/fetch``) on a tiny ``LMServingEngine`` on the CPU,
and the graph executor's (``graph/stage``, ``graph/replay``) on the card.
The file imports neither JAX nor the JAX package."""
import numpy as np
import pytest
import torch

from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.obs import get_tracer
from bigdl_tpu_torch.serving import LMServingEngine

ENGINE_KW = dict(slots=2, cache_len=24, block_len=4, max_new_tokens=6,
                 prefill_buckets=(4, 8, 16))
PROMPTS = (4, 7, 9)          # three requests on two slots: one queues


@pytest.fixture
def tracer():
    """The process-wide tracer, cleared and on for the test; put back as
    it was after."""
    tr = get_tracer()
    was, rate = tr.enabled, tr.sample_rate
    tr.clear()
    tr.enable()
    tr.set_sample_rate(1.0)
    yield tr
    if not was:
        tr.disable()
    tr.set_sample_rate(rate)
    tr.clear()


def _lm(device="cpu"):
    return TransformerLM(vocab_size=31, hidden_size=16, n_head=2,
                         n_layers=1, max_len=32, pos_encoding="rope",
                         device=device).build(seed=0)


def _serve(lm, **kw):
    """Serve PROMPTS to the end; the engine is closed when this returns,
    so every span of its worker is in the ring."""
    eng = LMServingEngine(lm, **dict(ENGINE_KW, device=lm.device, **kw))
    try:
        eng.warmup()
        rng = np.random.RandomState(1)
        streams = [eng.submit(rng.randint(1, 31, size=n).astype(np.int32),
                              max_new_tokens=4) for n in PROMPTS]
        for s in streams:
            s.result(timeout=120)
    finally:
        eng.close()
    return streams


def _named(events, name):
    return [e for e in events if e.get("name") == name]


def _inside(child, parent):
    return (child["tid"] == parent["tid"] and child["ts"] >= parent["ts"]
            and child["ts"] + child["dur"]
            <= parent["ts"] + parent["dur"] + 1e-3)


def _worker_events(tracer):
    """The events of the engine's worker thread: the thread that recorded
    the decode steps."""
    events = tracer.events()
    steps = _named(events, "lm/decode_step")
    assert steps
    tid = steps[0]["tid"]
    assert all(s["tid"] == tid for s in steps)
    return [e for e in events if e["tid"] == tid]


def test_each_decode_step_lies_in_one_round_with_one_token_pick(tracer):
    _serve(_lm())
    mine = _worker_events(tracer)
    rounds = _named(mine, "lm/round")
    steps = _named(mine, "lm/decode_step")
    picks = _named(mine, "lm/token_pick")
    assert len(picks) == len(steps)
    for st in steps:
        assert sum(_inside(st, r) for r in rounds) == 1
    for p in picks:
        (r,) = [r for r in rounds if _inside(p, r)]
        # the pick follows its step inside the round
        (st,) = [s for s in steps if _inside(s, r)]
        assert p["ts"] >= st["ts"] + st["dur"] - 1e-3
        assert p["args"]["active"] == st["args"]["active"]
    for r in rounds:
        assert r["args"]["active"] >= 0 and r["args"]["admitted"] >= 0
        assert r["args"]["active"] or r["args"]["admitted"] or any(
            _inside(p, r) for p in _named(mine, "lm/prefill"))
    # every request was admitted in some round
    assert sum(r["args"]["admitted"] for r in rounds) == len(PROMPTS)


def test_fetches_inside_decode_steps_and_after_final_prefill_chunks(tracer):
    _serve(_lm())
    mine = _worker_events(tracer)
    steps = _named(mine, "lm/decode_step")
    fetches = _named(mine, "lm/fetch")
    decode = [f for f in fetches if f["args"]["what"] == "decode"]
    prefill = [f for f in fetches if f["args"]["what"] == "prefill"]
    for st in steps:
        assert sum(_inside(f, st) for f in decode) == 1
    assert len(decode) == len(steps)
    # one request's prompt fits one chunk: a fetch after every prefill,
    # outside it, in the round that ran it
    prefills = _named(mine, "lm/prefill")
    assert len(prefills) == len(PROMPTS) == len(prefill)
    rounds = _named(mine, "lm/round")
    for pf in prefills:
        after = [f for f in prefill
                 if f["ts"] >= pf["ts"] + pf["dur"] - 1e-3]
        f = min(after, key=lambda f: f["ts"])
        assert not _inside(f, pf)
        (r,) = [r for r in rounds if _inside(pf, r)]
        assert _inside(f, r)
    for f in decode:
        assert f["args"]["bytes"] == ENGINE_KW["slots"] * 31 * 4
    for f in prefill:
        assert f["args"]["bytes"] == 31 * 4


def test_round_spans_carry_cpu_time_and_no_request_ids(tracer):
    _serve(_lm())
    mine = _worker_events(tracer)
    for name in ("lm/round", "lm/token_pick", "lm/fetch"):
        spans = _named(mine, name)
        assert spans, name
        for s in spans:
            # the reader of off-CPU time reads the rounds' and fetches'
            if name == "lm/token_pick":
                assert "cpu_us" not in s["args"]
            else:
                assert s["args"]["cpu_us"] >= 0
            assert "request_id" not in s["args"]
    # on the CPU every entry is eager: no graph spans
    assert not [e for e in mine if e["name"].startswith("graph/")]


def test_round_spans_are_not_request_sampled(tracer):
    tracer.set_sample_rate(0.0)
    _serve(_lm())
    events = tracer.events()
    assert not _named(events, "lm/decode_round")   # per-request: sampled
    steps = _named(events, "lm/decode_step")
    assert steps
    assert len(_named(events, "lm/token_pick")) == len(steps)
    assert _named(events, "lm/round") and _named(events, "lm/fetch")


def test_tracing_off_records_nothing():
    tr = get_tracer()
    was = tr.enabled
    tr.disable()
    tr.clear()
    try:
        _serve(_lm())
        assert len(tr) == 0
    finally:
        if was:
            tr.enable()


@pytest.fixture
def card():
    """The card, decided when the test runs (never at import time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_stage_and_replay_nest_in_decode_steps_on_card(card, tracer):
    # head size 64, as the card's flash and paged kernels take it
    lm = TransformerLM(vocab_size=97, hidden_size=128, n_head=2, n_layers=2,
                       max_len=128, attention_impl="flash",
                       device=card).build(seed=0)
    _serve(lm, cache_len=64, block_len=16, prefill_buckets=(16, 32),
           attention_impl="flash", decode_attn="paged_kernel",
           cuda_graphs=True)
    mine = _worker_events(tracer)
    steps = _named(mine, "lm/decode_step")
    stages = _named(mine, "graph/stage")
    replays = _named(mine, "graph/replay")
    for st in steps:
        (sg,) = [s for s in stages if _inside(s, st)]
        (rp,) = [r for r in replays if _inside(r, st)]
        assert sg["ts"] + sg["dur"] <= rp["ts"] + 1e-3
        assert "cpu_us" not in sg.get("args", {})
        (f,) = [f for f in _named(mine, "lm/fetch") if _inside(f, st)]
        assert f["ts"] >= rp["ts"] + rp["dur"] - 1e-3
    # the prefills' graphs too
    for pf in _named(mine, "lm/prefill"):
        assert any(_inside(r, pf) for r in replays)
