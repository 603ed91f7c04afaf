"""The readers of the engine's round spans on synthetic event lists: each
against a hand count, and none of them reading anything from a program
that records none of these spans."""
import pytest

from h100_bench.bench import common, rounds

NEW = ("token_pick_ms", "round_self_ms", "decode_launch_ms",
       "host_offcpu_share", "gc_pause_share")
WORKER, OTHER = 11, 22


class _Run:
    tracer_epoch = 100.0          # host seconds at the tracer's ts 0
    seconds = 1.0                 # the window's length
    settings = {"profile_seconds": 0.2}   # profiled from 0.5 s (half)


def _x(name, start_ms, end_ms, tid=WORKER, **args):
    ev = {"name": name, "ph": "X", "ts": start_ms * 1e3,
          "dur": (end_ms - start_ms) * 1e3, "pid": 1, "tid": tid}
    if args:
        ev["args"] = args
    return ev


def _ctx(events, window_ms=(0.0, 1000.0)):
    a, b = window_ms
    return {"kind": "serve", "run": _Run(), "events": events,
            "window": (100.0 + a / 1e3, 100.0 + b / 1e3)}


def _round(t, tid=WORKER):
    """One round at ``t`` ms: 10 ms, CPU 6 ms; a decode step from 1 to 6
    (staging 1-2, replay 2-3, the fetch 3-6, CPU 0.5 ms), the token pick
    6.5-8."""
    return [
        _x("lm/round", t, t + 10, tid, active=2, admitted=0, cpu_us=6000.0),
        _x("lm/decode_step", t + 1, t + 6, tid, active=2),
        _x("graph/stage", t + 1, t + 2, tid, cpu_us=900.0),
        _x("graph/replay", t + 2, t + 3, tid),
        _x("lm/fetch", t + 3, t + 6, tid, what="decode", bytes=8,
           cpu_us=500.0),
        _x("lm/token_pick", t + 6.5, t + 8, tid, active=2, cpu_us=1400.0),
    ]


def read(name, ctx):
    return common.metric_reader(name).read(ctx)


def test_each_reader_against_a_hand_count():
    events = _round(100.0) + _round(200.0)
    events.append(_x("py/gc", 300.0, 302.0, OTHER, generation=0,
                     collected=4))
    ctx = _ctx(events)
    assert read("token_pick_ms", ctx) == pytest.approx(1.5)
    # 10 ms less the step (1-6) and the pick (6.5-8): the staging, the
    # replay and the fetch lie inside the step and count once
    assert read("round_self_ms", ctx) == pytest.approx(3.5)
    assert read("decode_launch_ms", ctx) == pytest.approx(2.0)
    # (6000 - 500) us of CPU over (10 - 3) ms of wall, off the fetch
    assert read("host_offcpu_share", ctx) == pytest.approx(
        100 * (1 - 5.5 / 7.0))
    # 2 ms of the 1 s window, on another thread
    assert read("gc_pause_share", ctx) == pytest.approx(0.2)


def test_only_spans_wholly_inside_the_window_count():
    events = _round(100.0) + _round(2000.0) + _round(995.0)
    events[5]["dur"] = 10e3                    # a 10 ms pick, inside
    events += [_x("py/gc", 1500.0, 1600.0, OTHER, generation=2,
                  collected=0),
               _x("py/gc", 999.0, 1001.0, OTHER, generation=0,
                  collected=0),
               _x("py/gc", 500.0, 502.0, OTHER, generation=0,
                  collected=0)]
    ctx = _ctx(events)
    # the round at 995 ms ends past the window, and its pick with it
    assert read("token_pick_ms", ctx) == pytest.approx(10.0)
    assert read("gc_pause_share", ctx) == pytest.approx(0.2)


def test_children_on_another_thread_are_not_the_rounds():
    events = _round(100.0)
    # another thread's pick inside the round's interval
    events.append(_x("lm/token_pick", 101.0, 109.0, OTHER, cpu_us=1.0))
    events.append(_x("lm/fetch", 101.0, 109.0, OTHER, what="decode",
                     bytes=8, cpu_us=1.0))
    ctx = _ctx(events)
    assert read("round_self_ms", ctx) == pytest.approx(3.5)
    assert read("host_offcpu_share", ctx) == pytest.approx(
        100 * (1 - 5.5 / 7.0))


def test_an_eager_step_has_no_launch_reading():
    events = [e for e in _round(100.0) if not e["name"].startswith("graph/")]
    ctx = _ctx(events)
    assert read("decode_launch_ms", ctx) is None
    assert read("round_self_ms", ctx) == pytest.approx(3.5)


def test_a_program_without_the_spans_reads_nothing():
    # the spans an older program records: a step, a prefill, a request's
    old = [_x("lm/decode_step", 1.0, 6.0, active=2),
           _x("lm/prefill", 7.0, 9.0, bucket=16, prompt_len=9,
              prefix_len=0),
           _x("lm/decode_round", 1.0, 6.0, request_id="r1-1", slot=0,
              step=0),
           {"name": "h100_bench/epoch", "ph": "i", "s": "t", "ts": 0.0,
            "pid": 1, "tid": OTHER}]
    for name in NEW:
        assert read(name, _ctx(old)) is None, name
        assert read(name, _ctx([])) is None, name


def test_a_training_run_is_not_read():
    ctx = dict(_ctx(_round(100.0)), kind="train")
    for name in NEW:
        assert read(name, ctx) is None, name


class _Slice:
    """A device trace whose profiled slice starts ``at_ms`` into the
    window."""

    def __init__(self, at_ms):
        self.t0 = 100.0 + at_ms / 1e3
        self.t1 = self.t0 + 3.0


def test_the_profiled_slice_and_what_follows_it_are_left_out():
    # rounds before the slice at 500 ms; inside it the profiler makes a
    # launch 50 ms long, and its stop stalls a pick for 4 s
    events = _round(100.0) + _round(200.0)
    slow = _round(600.0)
    slow[3]["dur"] = 50e3
    stalled = _round(900.0)
    stalled[-1]["dur"] = 4000e3
    events += slow + stalled
    events.append(_x("py/gc", 300.0, 305.0, OTHER, generation=2,
                     collected=0))
    events.append(_x("py/gc", 700.0, 800.0, OTHER, generation=2,
                     collected=0))
    ctx = dict(_ctx(events), devtrace=_Slice(500.0))
    assert rounds.read_part(ctx) == (100.0, pytest.approx(100.5))
    assert read("token_pick_ms", ctx) == pytest.approx(1.5)
    assert read("decode_launch_ms", ctx) == pytest.approx(2.0)
    assert read("round_self_ms", ctx) == pytest.approx(3.5)
    # 5 ms of the 500 ms before the slice
    assert read("gc_pause_share", ctx) == pytest.approx(1.0)
    # a profiler whose start took 300 ms: its first mark at 800 ms; the
    # part read still ends where the runner started it
    late = dict(ctx, devtrace=_Slice(800.0))
    assert rounds.read_part(late) == (100.0, pytest.approx(100.5))
    assert read("token_pick_ms", late) == pytest.approx(1.5)
    _Run.seconds = 10.0           # 10 s, profiled from 6 s: the slice's
    try:                          # first mark at 500 ms comes first
        assert rounds.read_part(ctx) == (100.0, pytest.approx(100.5))
        assert rounds.read_part(late)[1] == pytest.approx(100.8)
    finally:
        _Run.seconds = 1.0
    # without a device trace the whole window counts, wholly inside it
    whole = _ctx(events)
    assert read("token_pick_ms", whole) == pytest.approx(1.5)
    assert read("decode_launch_ms", whole) > 2.0
    assert read("gc_pause_share", whole) == pytest.approx(10.5)


def test_a_stall_is_left_out_of_the_means_and_logged(capsys):
    # 40 rounds of 10 ms; one with 300 ms of its own time (a generation-2
    # pass: no stall, it counts); one stalled 12 s before its step; one
    # whose launch and pick each stall 4 s
    events = []
    for k in range(40):
        events += _round(100.0 + 12.0 * k)
    slow = _round(700.0)
    slow[0]["dur"] = 310e3
    late = _round(1100.0)
    late[0]["dur"] = 12010e3
    for e in late[1:]:
        e["ts"] += 12000e3
    stuck = _round(14000.0)
    stuck[0]["dur"] = 8010e3
    stuck[1]["dur"] += 4000e3                  # the step, its launch late
    for e in stuck[2:5]:
        e["ts"] += 4000e3
    stuck[5]["ts"] += 4000e3                   # the pick, 4 s long
    stuck[5]["dur"] = 4000e3
    events += slow + late + stuck
    ctx = _ctx(events, window_ms=(0.0, 30000.0))
    assert read("token_pick_ms", ctx) == pytest.approx(1.5)
    assert read("decode_launch_ms", ctx) == pytest.approx(2.0)
    # the 300 ms round and the stuck one's 5 ms count; the late one not
    assert read("round_self_ms", ctx) == pytest.approx(
        (40 * 3.5 + 303.5 + 5.0) / 42)
    # (6000 - 500) us a round over (10 - 3) ms, and the slow round's
    # 300 ms off the CPU; both stalled rounds left out
    assert read("host_offcpu_share", ctx) == pytest.approx(
        100 * (1 - 41 * 5.5 / (40 * 7.0 + 307.0)))
    err = capsys.readouterr().err
    for name in ("token_pick_ms", "decode_launch_ms", "round_self_ms"):
        assert f"[rounds] {name}: left out 1 stall(s)" in err, name
    assert "[rounds] host_offcpu_share: left out 2 stall(s)" in err
    assert "12003.5 ms at 1.100 s into the window" in err
    assert "4000.0 ms at 18.007 s into the window" in err    # the pick
    assert "[host_offcpu_share] CPU clock tick 0.500 ms" in err


def test_the_part_read_ends_where_the_runner_starts_the_profiler(
        monkeypatch):
    from types import SimpleNamespace

    from h100_bench.runners import serve
    now = [100.0]
    started = []

    class Clock:
        @staticmethod
        def perf_counter():
            return now[0]

        @staticmethod
        def sleep(s):
            now[0] += max(0.0, s)

    class Trace:
        t0 = None

        def start(self):
            started.append(now[0])

        def mark(self, *a):
            pass

        def stop(self):
            pass

    monkeypatch.setattr(serve, "time", Clock)
    for seconds in (1.0, 6.0, 51.0):
        now[0] = 100.0
        run = SimpleNamespace(seconds=seconds, devtrace=Trace(),
                              settings={"profile_seconds": 3.0})
        serve.ServeRun._profile(run, 100.0)
        ctx = {"window": (100.0, 100.0 + seconds), "run": run,
               "devtrace": run.devtrace}
        assert rounds.read_part(ctx)[1] == pytest.approx(started[-1])
