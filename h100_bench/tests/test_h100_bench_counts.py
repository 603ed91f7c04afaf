"""The operation and byte counts against hand counts at small shapes."""
import numpy as np
import pytest

from h100_bench.bench import flops
from h100_bench.bench.common import percentile

S = {"hidden": 4, "ffn": 8, "layers": 2, "vocab": 10, "heads": 2,
     "head_dim": 2, "positions": 16}


def test_dense_and_head():
    # per layer: q, k, v, o (4 x 4x4) and the MLP (4x8, 8x4), 2 ops a MAC
    assert flops.dense_flops_per_token(S) == 2 * (4 * 16 + 2 * 32) * 2
    assert flops.head_flops(S) == 2 * 4 * 10


def test_causal_attention_counts_each_query_at_its_keys():
    # queries at 0, 1, 2 see 1, 2, 3 keys: QK and PV, 2 ops a MAC each,
    # over hidden 4, two layers
    assert flops.attention_flops(S, 0, 3) == 2 * 2 * 4 * (1 + 2 + 3) * 2
    assert flops.attention_flops(S, 5, 5) == 0.0
    assert flops.attention_flops(S, 2, 3) == 2 * 2 * 4 * 3 * 2


def test_prefill_and_decode():
    dense, head = flops.dense_flops_per_token(S), flops.head_flops(S)
    assert flops.prefill_flops(S, 3, 0) == \
        3 * dense + flops.attention_flops(S, 0, 3) + head
    # a cached prefix of 2: only position 2 is computed, at 3 keys
    assert flops.prefill_flops(S, 3, 2) == \
        dense + 2 * 2 * 4 * 3 * 2 + head
    assert flops.decode_flops(S, 6) == dense + 2 * 2 * 4 * 7 * 2 + head


def test_kv_bytes_count_each_row_once():
    # K and V rows of 4 floats at 7 positions, two layers
    assert flops.kv_bytes(S, 7) == 2 * 2 * 7 * 4 * 4


def test_train_step():
    fwd = (flops.dense_flops_per_token(S) + flops.head_flops(S)) * 3 * 5 \
        + flops.attention_flops(S, 0, 5) * 3
    assert flops.train_flops_per_step(S, 3, 5) == 3 * fwd


def test_flash_train_counts():
    ops, nbytes = flops.flash_train_counts(S, 3, 5)
    pairs = 5 * 6 / 2
    assert ops == 6 * 2 * 2 * pairs * 3 * 2 * 2
    rows = 3 * 2 * 5
    assert nbytes == (rows * 2 * 12 + rows * 2) * 4 * 2


def test_roofline_takes_the_longer_bound():
    t, by = flops.roofline_seconds(165e12, 1.0)
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = flops.roofline_seconds(1.0, 3.35e12)
    assert by == "bytes" and t == pytest.approx(1.0)


def test_union_and_percentile():
    assert flops.union_seconds([(0, 1), (0.5, 2), (3, 4)]) == 3.0
    assert flops.union_seconds([]) == 0.0
    xs = list(np.random.default_rng(0).random(101))
    for q in (5, 50, 95):
        assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_shared_prefix_rows_count_once():
    from types import SimpleNamespace as NS
    from h100_bench.bench import reads

    def rec(rid, session, prompt):
        return NS(stream=NS(request_id=rid),
                  req=NS(session=session, prompt=[0] * prompt))

    def ev(name, t, dur, **args):
        return {"ph": "X", "name": name, "ts": t * 1e6, "dur": dur * 1e6,
                "args": args}

    records = [rec("a", 0, 40), rec("b", 0, 40), rec("c", 1, 10)]
    events = [ev("lm/decode_step", 1.0, 0.1),
              ev("lm/decode_round", 1.0, 0.1, request_id="b", step=0),
              ev("lm/decode_round", 1.0, 0.1, request_id="c", step=2),
              {"ph": "i", "name": "lm/radix_match",
               "args": {"request_id": "b", "matched_tokens": 32}},
              ev("lm/decode_step", 2.0, 0.1),
              ev("lm/decode_round", 2.0, 0.1, request_id="a", step=5),
              ev("lm/decode_round", 2.0, 0.1, request_id="b", step=1)]
    ctx = {"records": records, "events": events,
           "run": NS(tracer_epoch=0.0)}
    steps = reads.spans(ctx, "lm/decode_step")
    # step 0: b reads its 9 own rows and the 32 it matched, c its 13;
    # step 1: a (the owner, matched nothing) reads 46 rows, b its own 10
    assert reads.unique_kv_rows(ctx, steps) == (9 + 32 + 13) + (46 + 10)
    assert sorted(reads.decode_positions(ctx, steps)) == [12, 40, 41, 45]


# -- the device trace, read from a Chrome export made by hand ----------- #
def _trace(offset_us, brackets_s, drift_ppm=150.0, host_ops=True):
    """A DeviceTrace read from events on a clock ``offset_us`` ahead of
    the host's and running ``drift_ppm`` fast: bursts of four marks with
    the given brackets, a prefill graph launched inside its span and a
    decode graph launched just after it."""
    from h100_bench.bench.devtrace import MARK, DeviceTrace
    tr = DeviceTrace("unused", host_ops=host_ops)
    tr._tid = 1

    def on_trace(t):
        return t * (1 + drift_ppm * 1e-6) * 1e6 + offset_us

    events = []
    for i, br in enumerate(brackets_s):
        for j in range(4):
            h = 1.0 + 0.03 * i + 1e-4 * j
            label = f"tick/{i}/{j}"
            tr._marks.append((i, label, h, h + br))
            ts = on_trace(h + br / 2)
            if host_ops:
                events.append({"cat": "user_annotation",
                               "name": f"{MARK}/{label}", "ts": ts,
                               "dur": 1})
            else:
                events.append({"cat": "cuda_runtime", "tid": 1,
                               "name": "cudaEventRecord", "ts": ts,
                               "dur": 1, "args": {"correlation": -i}})
    tr.t0, tr.t1 = 1.0, 2.0

    # the prefill span runs 1.500-1.502 s, its graph launched at 1.501;
    # the decode step's graph at 1.5025
    for corr, (t, kernels) in {
            7: (1.501, [("void flash_fwd_kernel<float>", 1.503, 1.513),
                        ("sgemm", 1.513, 1.543)]),
            8: (1.5025, [("paged_chunk_kernel", 1.545, 1.546)])}.items():
        events.append({"cat": "cuda_runtime", "name": "cudaGraphLaunch",
                       "ts": on_trace(t), "dur": 5,
                       "args": {"correlation": corr}})
        for name, a, b in kernels:
            events.append({"cat": "kernel", "name": name, "ts": on_trace(a),
                           "dur": on_trace(b) - on_trace(a),
                           "args": {"correlation": corr}})
    tr._read(events)
    return tr


@pytest.mark.parametrize("host_ops", [True, False])
def test_the_trace_ties_a_graph_to_its_launch_by_correlation(host_ops):
    tr = _trace(5e5, [2e-5] * 30, host_ops=host_ops)
    assert tr.clock["residual_us_max"] < 1.0
    assert tr.clock["drift_ppm"] == pytest.approx(150.0, abs=1.0)
    (graph,) = tr.graphs_in(1.4998, 1.5022)
    assert {o.name for o in graph} == {"void flash_fwd_kernel<float>",
                                       "sgemm"}
    # the device's times come back on the host's clock, drift and all
    assert min(o.start for o in graph) == pytest.approx(1.503, abs=1e-6)
    assert max(o.end for o in graph) == pytest.approx(1.543, abs=1e-6)
    assert len(tr.graphs_in(1.4998, 1.6)) == 2


def test_a_poor_clock_fit_is_refused():
    from h100_bench.bench.devtrace import ClockFitError
    with pytest.raises(ClockFitError):
        _trace(5e5, [5e-3] * 30)        # every mark waited 5 ms
    with pytest.raises(ClockFitError):
        _alternating()                  # every other mark 0.3 ms late
    # a few marks that read late drop out of the fit
    tr = _trace(5e5, [2e-5] * 27 + [4e-3] * 3)
    assert tr.clock["used"] == 27


def _alternating():
    from h100_bench.bench.devtrace import fit_clock
    marks, stamps = [], {}
    for i in range(30):
        h = 1.0 + 0.03 * i
        marks.append((i, f"m/{i}", h, h + 2e-5))
        stamps[f"m/{i}"] = (h + 1e-5 + (3e-4 if i % 2 else 0.0)) * 1e6
    fit_clock(marks, stamps)


def test_prefill_mfu_reads_only_the_graph_its_span_launched():
    from types import SimpleNamespace

    from h100_bench.bench import common
    from h100_bench.bench.weights import sizes
    tr = _trace(5e5, [2e-5] * 30)
    s = sizes({"vocab_size": 97, "n_embd": 128, "n_head": 2,
               "n_layer": 2, "n_positions": 128, "layer_norm_epsilon": 1e-5})
    run = SimpleNamespace(tracer_epoch=0.0)
    ctx = {"kind": "serve", "devtrace": tr, "sizes": s, "run": run,
           "events": [{"ph": "X", "name": "lm/prefill", "ts": 1.5e6,
                       "dur": 2000.0, "args": {"bucket": 64,
                                               "prompt_len": 40,
                                               "prefix_len": 0}}]}
    got = common.metric_reader("prefill_mfu").read(ctx)
    # the prefill's graph ran from 1.503 to 1.543 s
    want = 100.0 * flops.prefill_flops(s, 40, 0) / 0.040 / flops.FP32_PEAK
    assert got == pytest.approx(want, rel=1e-6)
