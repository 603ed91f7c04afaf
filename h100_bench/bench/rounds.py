"""What the readers of the serving engine's round spans share (``lm/round``,
``lm/token_pick``, ``lm/fetch``, ``graph/stage``, ``graph/replay``,
``py/gc``): the program's spans on the host clock with the thread that
recorded each, those the readers read, and the spans that one span holds
on its own thread.

The readers read the spans that lie wholly inside the measured window
and end before the profiler is started.  The profiler changes what the
host does: with CUPTI tracing each graph launch takes tens of times
longer, and starting or stopping the profiler has held the interpreter
for seconds, so the host's phases are read where no profiler runs.

The readers of a mean (and of a share that sums rounds) leave out a
stall: a span over ``STALL_FACTOR`` times its kind's median in the part
read.  One round that the worker spent seconds in (the profiler's start
or stop has held it 4-5 s; the slowest work by design, a generation-2
collection or a 512-token prefill, takes under 0.35 s) would otherwise
move a mean of some 2,000 rounds several-fold.  What is left out is
logged, with its length and its start in the window, so a stall is seen
and not hidden.

A program without these spans (one older than them) gives no spans, and
every reader then returns None."""
from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Sequence, Tuple

from h100_bench.bench.common import log

#: a child that ends this far past its parent's end still lies inside it
#: (the host clock's microseconds round-trip through floats)
EPS_S = 1e-9

#: a span this many times its kind's median is a stall (module docstring)
STALL_FACTOR = 1000.0


class Span(NamedTuple):
    start: float        # host clock, seconds
    end: float
    tid: int
    args: dict

    @property
    def seconds(self) -> float:
        return self.end - self.start


def _start(s: Span) -> float:
    return s.start


def spans(ctx: dict, names: Iterable[str]) -> Dict[str, List[Span]]:
    """Every span of the run named in ``names``, by name, by start."""
    names = set(names)
    epoch = ctx["run"].tracer_epoch
    out: Dict[str, List[Span]] = {n: [] for n in names}
    for e in ctx["events"]:
        if e.get("ph") == "X" and e.get("name") in names:
            a = epoch + e["ts"] / 1e6
            out[e["name"]].append(Span(a, a + e["dur"] / 1e6, e["tid"],
                                       e.get("args", {})))
    for v in out.values():
        v.sort(key=_start)
    return out


def read_part(ctx: dict) -> Tuple[float, float]:
    """The part of the window the readers read: from its start to its
    end, or, where a device trace was taken, to the time the serving
    runner starts the profiler (``ServeRun._profile``'s schedule) or the
    slice's first mark, whichever is earlier."""
    t0, t1 = ctx["window"]
    tr = ctx.get("devtrace")
    if tr is not None:
        run = ctx["run"]
        span = float(run.settings.get("profile_seconds", 3.0))
        t1 = min(t1, t0 + max(0.5 * run.seconds,
                              run.seconds - 1.0 - span))
        if tr.t0 is not None:
            t1 = min(t1, tr.t0)
    return t0, t1


def in_window(ctx: dict, items: Sequence[Span]) -> List[Span]:
    """The spans that lie wholly inside :func:`read_part`."""
    t0, t1 = read_part(ctx)
    return [s for s in items if t0 <= s.start and s.end <= t1]


class Children:
    """Spans grouped by thread, to find those a span holds."""

    def __init__(self, items: Iterable[Span]):
        self._by_tid: Dict[int, List[Span]] = defaultdict(list)
        for s in items:
            self._by_tid[s.tid].append(s)
        for v in self._by_tid.values():
            v.sort(key=_start)
        self._starts = {t: [s.start for s in v]
                        for t, v in self._by_tid.items()}

    def of(self, parent: Span) -> List[Span]:
        """The spans on ``parent``'s thread that lie inside it."""
        items = self._by_tid.get(parent.tid, [])
        starts = self._starts.get(parent.tid, [])
        lo = bisect.bisect_left(starts, parent.start - EPS_S)
        hi = bisect.bisect_right(starts, parent.end + EPS_S)
        return [s for s in items[lo:hi] if s.end <= parent.end + EPS_S]


def mean(values: Sequence[float]):
    return sum(values) / len(values) if values else None


def without_stalls(ctx: dict, metric: str, rows: Sequence[tuple]) -> list:
    """The ``rows`` that are no stall: each row's first item is a span's
    reading in seconds and its second the span; a stall reads over
    ``STALL_FACTOR`` times the median.  Logs what it leaves out under
    ``metric``'s name."""
    if not rows:
        return []
    cut = STALL_FACTOR * statistics.median(r[0] for r in rows)
    out = [r for r in rows if r[0] > cut]
    if not out:
        return list(rows)
    worst = max(out, key=lambda r: r[0])
    log(f"[rounds] {metric}: left out {len(out)} stall(s) over "
        f"{STALL_FACTOR:g}x the median ({1e3 * cut:.3f} ms), "
        f"{1e3 * sum(r[0] for r in out):.1f} ms in all; the longest "
        f"{1e3 * worst[0]:.1f} ms at "
        f"{worst[1].start - ctx['window'][0]:.3f} s into the window")
    return [r for r in rows if r[0] <= cut]


def steady_mean(ctx: dict, metric: str, rows: Sequence[tuple]):
    """The mean of the rows' readings (seconds) less the stalls."""
    return mean([r[0] for r in without_stalls(ctx, metric, rows)])
