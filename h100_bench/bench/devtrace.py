"""The device trace: ``torch.profiler`` over a steady slice of the
window, read back from its Chrome export.

Device operations are the trace's kernels, copies and fills.  Each
carries the correlation id of the host call that launched it (a kernel
launch, or the launch of a captured CUDA graph, whose kernels all share
its id): that is how a kernel is tied to the call, and the call, whose
time is on the host's timeline, to the program's span around it.  Marks
recorded on the harness's own thread tie the trace's clock to
``time.perf_counter``; a trace whose marks do not agree on that to
within ``MAX_CLOCK_US`` is refused, so no reading rests on a poor fit.
"""
from __future__ import annotations

import bisect
import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from h100_bench.bench.flops import union_seconds

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARK = "h100_bench/mark"

#: the widest bracket of a mark used in the clock's fit, and the widest
#: disagreement among those marks, that a trace may have (microseconds)
MAX_CLOCK_US = 100.0


class ClockFitError(RuntimeError):
    """The profiler's clock could not be tied to the host's closely
    enough to place the program's spans on it."""


def warm_profiler() -> float:
    """One empty profiling session: the profiler's first start loads and
    sets up CUPTI, which takes seconds, and belongs in set-up and not in
    the slice.  Returns its seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    return time.perf_counter() - t


class Op:
    """One device operation (seconds on the host's perf_counter scale)."""

    __slots__ = ("name", "cat", "start", "end", "launched", "corr")

    def __init__(self, name, cat, start, end, launched, corr=None):
        self.name = name
        self.cat = cat
        self.start = start
        self.end = end
        self.launched = launched   # the launching call's host time, or None
        self.corr = corr           # the launching call's correlation id

    @property
    def seconds(self) -> float:
        return self.end - self.start


class DeviceTrace:
    """Profile between :meth:`start` and :meth:`stop`; after
    :meth:`collect`, ``ops`` (by start), ``host_ops`` (host calls and annotations) and the slice's
    ``t0``/``t1`` on the host clock."""

    def __init__(self, scratch: str, host_ops: bool = True):
        self._scratch = scratch
        self._host = host_ops
        self._prof = None
        #: (burst, label, host time before, host time after)
        self._marks: List[Tuple[int, str, float, float]] = []
        self.ops: List[Op] = []
        self.host_ops: List[Tuple[str, float, float]] = []
        #: every launch of a captured graph: (host time, correlation id)
        self.graph_launches: List[Tuple[float, int]] = []
        self.by_corr: Dict[int, List[Op]] = {}
        self.t0 = self.t1 = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA]
        if self._host:
            acts.append(ProfilerActivity.CPU)
        self._tid = threading.get_native_id()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.t0 = self.mark("start")

    def mark(self, label: str, n: int = 4) -> float:
        """A burst of ``n`` points of the trace at known host times, each
        bracketed by two readings of the host clock: annotations when
        host calls are traced, else CUDA runtime calls (event records)
        from this thread, which CUPTI stamps on the trace's clock.  The
        tightest of a burst goes into the clock's fit.  Returns the host
        time of the burst's start."""
        import torch
        burst = len({m[0] for m in self._marks})
        first = None
        for i in range(n):
            name = f"{label}/{burst}/{i}"
            t = time.perf_counter()
            if self._host:
                with torch.profiler.record_function(f"{MARK}/{name}"):
                    pass
            else:
                torch.cuda.Event().record()
            self._marks.append((burst, name, t, time.perf_counter()))
            first = t if first is None else first
        return first

    def stop(self) -> None:
        self.t1 = self.mark("stop")
        self._prof.__exit__(None, None, None)

    def collect(self) -> None:
        """Read the stopped profiler's trace (after the window: the
        export and its parse take seconds of the host)."""
        path = os.path.join(self._scratch, "trace.json")
        self._prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        self._read(events)

    def _read(self, events: list) -> None:
        if self._host:
            stamps = {e["name"][len(MARK) + 1:]: float(e["ts"])
                      for e in events if e.get("cat") == "user_annotation"
                      and str(e.get("name", "")).startswith(MARK + "/")}
        else:
            ours = [float(e["ts"]) for e in events
                    if e.get("cat") in LAUNCH_CATS
                    and e.get("tid") == self._tid
                    and "EventRecord" in str(e.get("name", ""))]
            stamps = _match_marks(self._marks, ours)
        icpt, slope, self.clock = fit_clock(self._marks, stamps)

        def host(ts_us: float) -> float:
            return (ts_us / 1e6 - icpt) / slope

        launch = {}
        graphs: Dict[int, float] = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "args" in e:
                c = e["args"].get("correlation")
                if c is not None:
                    launch[c] = host(float(e["ts"]))
                    if "GraphLaunch" in str(e.get("name", "")):
                        graphs[c] = launch[c]   # runtime or driver call
        ops = []
        by_corr: Dict[int, List[Op]] = {}
        for e in events:
            if e.get("cat") in DEVICE_CATS and "dur" in e:
                ts = float(e["ts"])
                c = e.get("args", {}).get("correlation")
                op = Op(e.get("name", "?"), e["cat"], host(ts),
                        host(ts + float(e["dur"])), launch.get(c), c)
                ops.append(op)
                if c is not None:
                    by_corr.setdefault(c, []).append(op)
        ops.sort(key=lambda o: o.start)
        self.ops = ops
        self.by_corr = by_corr
        self.graph_launches = sorted((t, c) for c, t in graphs.items())
        self._starts = [o.start for o in ops]
        self._longest = max((o.seconds for o in ops), default=0.0)
        self.host_ops = sorted(
            (e.get("name", "?"), host(float(e["ts"])),
             host(float(e["ts"]) + float(e["dur"])))
            for e in events
            if e.get("cat") in ("cpu_op", "user_annotation",
                                "python_function") and "dur" in e
            and not str(e.get("name", "")).startswith(MARK))
        from h100_bench.bench.common import log
        log(f"[trace] {len(events)} events, {len(ops)} device operations "
            f"({sum(o.launched is not None for o in ops)} tied to their "
            f"launch), {len(self.host_ops)} host calls, slice "
            f"{self.t1 - self.t0:.3f} s, clock {self.clock}")

    # -- reading --------------------------------------------------------- #
    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def overlapping(self, a: float, b: float) -> List[Op]:
        """The device operations that run at some time in [a, b]."""
        lo = bisect.bisect_left(self._starts, a - self._longest)
        hi = bisect.bisect_right(self._starts, b)
        return [o for o in self.ops[lo:hi] if o.end > a]

    def busy_s(self, a: Optional[float] = None,
               b: Optional[float] = None) -> float:
        """Seconds in [a, b] (default: the slice) in which a device
        operation ran."""
        a = self.t0 if a is None else a
        b = self.t1 if b is None else b
        return union_seconds((max(o.start, a), min(o.end, b))
                             for o in self.overlapping(a, b))

    def busy_in(self, spans: Iterable[Tuple[float, float]]) -> float:
        """Device-busy seconds inside each of ``spans``, summed."""
        return sum(self.busy_s(a, b) for a, b in spans)

    def graphs_in(self, a: float, b: float) -> List[List[Op]]:
        """The device operations of each captured graph whose launch call
        the host made in [a, b], one list a launch, tied to it by its
        correlation id."""
        lo = bisect.bisect_left(self.graph_launches, (a, -1))
        out = []
        for t, c in self.graph_launches[lo:]:
            if t > b:
                break
            out.append(self.by_corr.get(c, []))
        return out

    def kernel_seconds(self, *substrings: str) -> Tuple[float, int]:
        """Summed device time and count of the kernels in the slice whose
        name holds any of ``substrings``."""
        t, n = 0.0, 0
        for o in self.ops:
            if o.cat == "kernel" and any(s in o.name for s in substrings):
                t += o.seconds
                n += 1
        return t, n

    def breakdown(self, spans: Sequence[Tuple[str, float, float]] = ()
                  ) -> Dict[str, list]:
        """The ten device operations that took most time (by name), and
        the ten longest idle gaps in the slice, each named by the program
        span (``spans``: name, start, end) or else the host call that
        covers its middle."""
        by_name: Dict[str, float] = {}
        for o in self.ops:
            key = o.name[:160]
            by_name[key] = by_name.get(key, 0.0) + o.seconds
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = []
        edge = self.t0
        for o in self.ops:
            if o.start > edge:
                gaps.append((edge, min(o.start, self.t1)))
            edge = max(edge, o.end)
            if edge >= self.t1:
                break
        if edge < self.t1:
            gaps.append((edge, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:10]:
            mid = (a + b) / 2
            label = _covering(spans, mid) or _covering(
                [(n, s, e) for n, s, e in self.host_ops], mid, longest=False)
            named.append([f"idle in {label or 'no host call'}", b - a])
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": named}


def _line(pts):
    """Least squares ``ts = icpt + slope * h`` through (h, ts) points."""
    n = len(pts)
    mh = sum(h for h, _ in pts) / n
    mt = sum(t for _, t in pts) / n
    shh = sum((h - mh) ** 2 for h, _ in pts)
    slope = (sum((h - mh) * (t - mt) for h, t in pts) / shh) if shh else 1.0
    return mt - slope * mh, slope


def fit_clock(marks, stamps) -> Tuple[float, float, dict]:
    """The line that takes the host's clock to the trace's: from each
    burst's tightest mark (bracket at most ``MAX_CLOCK_US``), fitted
    once, the points it leaves more than ``MAX_CLOCK_US`` off dropped,
    and fitted again.  The two clocks may tick at rates some hundred
    parts per million apart, so the line has a slope.  Raises
    :class:`ClockFitError` unless three bursts or more, and half of those
    tight enough, agree to within ``MAX_CLOCK_US``."""
    best: Dict[int, Tuple[float, float, float]] = {}
    for burst, label, a, b in marks:
        if label in stamps and (burst not in best
                                or b - a < best[burst][2]):
            best[burst] = (0.5 * (a + b), stamps[label] / 1e6, b - a)
    tol = MAX_CLOCK_US / 1e6
    tight = [(h, t) for h, t, br in best.values() if br <= tol]
    info = {"bursts": len({m[0] for m in marks}), "matched": len(best),
            "tight": len(tight)}
    kept = tight
    icpt = slope = None
    if len(tight) >= 3:
        icpt, slope = _line(tight)
        kept = [(h, t) for h, t in tight
                if abs(t - icpt - slope * h) <= tol]
        if len(kept) >= 3:
            icpt, slope = _line(kept)
    resid = ([abs(t - icpt - slope * h) for h, t in kept]
             if icpt is not None and len(kept) >= 3 else [float("inf")])
    info.update(used=len(kept), residual_us_max=max(resid) * 1e6,
                bracket_us_max=max((br for _, _, br in best.values()
                                    if br <= tol), default=0.0) * 1e6,
                drift_ppm=(slope - 1.0) * 1e6 if slope else None)
    if (len(kept) < 3 or 2 * len(kept) < len(tight)
            or max(resid) > tol or abs(slope - 1.0) > 1e-3):
        raise ClockFitError(
            f"the trace's clock is tied to the host's no closer than "
            f"{MAX_CLOCK_US} us: {info}")
    return icpt, slope, info


def _match_marks(marks, stamps, tol_us: float = 2000.0) -> dict:
    """Pair each mark (burst, label, host t before, host t after) with
    the trace stamp of its event record.  The offset that most of the
    twenty tightest marks agree on (each within ``tol_us`` of a stamp)
    finds each burst's stamps; a burst whose stamps number its marks is
    paired in order, and any other left out (records the profiler
    missed at its start, or that other code made on this thread)."""
    if not stamps:
        return {}
    stamps = sorted(stamps)
    hosts = [(label, 0.5 * (a + b) * 1e6, b - a) for _, label, a, b in marks]
    best = sorted(hosts, key=lambda h: h[2])[:20]

    def nearest(x):
        k = bisect.bisect_left(stamps, x)
        return min((stamps[j] for j in (k - 1, k) if 0 <= j < len(stamps)),
                   key=lambda v: abs(v - x))

    def support(off):
        return sum(1 for _, h, _ in best
                   if abs(nearest(h + off) - (h + off)) <= tol_us)

    off = max((s - h for _, h, _ in best for s in stamps), key=support)
    bursts: Dict[int, list] = {}
    for burst, label, a, b in marks:
        bursts.setdefault(burst, []).append((label, a * 1e6, b * 1e6))
    out = {}
    for ms in bursts.values():
        lo = bisect.bisect_left(stamps, ms[0][1] + off - tol_us)
        hi = bisect.bisect_right(stamps, ms[-1][2] + off + tol_us)
        if hi - lo == len(ms):
            for (label, _, _), s in zip(ms, stamps[lo:hi]):
                out[label] = s
    return out


def _covering(spans, t: float, longest: bool = True) -> Optional[str]:
    """The span covering time ``t``: the longest, or the innermost."""
    best = None
    for name, a, b in spans:
        if a <= t <= b:
            if best is None or ((b - a) > (best[2] - best[1])) == longest:
                best = (name, a, b)
    return best[0] if best else None
