"""Span tracing: one timeline for serving requests and training steps
(port of ``bigdl_tpu/obs/tracer.py``).

A thread-safe span API whose events land in a ring buffer and export as
Chrome trace-event JSON (loadable in Perfetto) or as a JSONL log.  The
disabled path is one attribute check returning a shared no-op context
manager; ``add_complete`` records a span retroactively from an explicit
start time.  Timestamps are ``time.perf_counter`` microseconds from the
tracer's epoch: the HOST clock.  A span around a CUDA graph launch
times the launch, not the device work, and nothing here synchronises a
device.

Toggled by ``BIGDL_TPU_TRACE`` (read at import for the process-wide
tracer; ``enable()``/``disable()`` flip it at runtime).  Serving entry
points mint a request id with :func:`mint_request_id` and stamp it into
span ``args``; ``BIGDL_TPU_TRACE_SAMPLE`` (0..1, default 1) decides,
by a deterministic hash of the id, which requests record their
per-round events, and :meth:`Tracer.span_tree` reassembles one
request's timeline from the ring.

Batch-level spans that ask where a worker's time went (``cpu_span``, or
``add_complete(..., cpu_ns0=...)``) also carry ``cpu_us``, the thread's
CPU time across the span (``time.thread_time_ns``): a span whose wall
time is long and whose CPU time is short waited for the interpreter
lock, a lock or the device.  While enabled, the tracer records each pass
of Python's garbage collector as a ``py/gc`` span on the thread that ran
it (a collection stops every Python thread).  The ring keeps the newest
``capacity`` events (:meth:`Tracer.set_capacity`); ``dropped`` counts
what a full ring evicted since tracing was turned on, and the exports
carry it.
"""
from __future__ import annotations

import gc
import itertools
import json
import os
import threading
import time
import weakref
import zlib
from collections import deque
from functools import wraps
from typing import Optional


def _env_enabled() -> bool:
    return os.environ.get("BIGDL_TPU_TRACE", "0").lower() in ("1", "true", "on")


def _env_sample_rate() -> float:
    try:
        rate = float(os.environ.get("BIGDL_TPU_TRACE_SAMPLE", "1"))
    except ValueError:
        return 1.0
    return min(max(rate, 0.0), 1.0)


#: process-wide request-id sequence; ids stay unique across engines and
#: batchers inside one process, and the pid prefix disambiguates merged
#: multi-process traces
_REQ_SEQ = itertools.count(1)


def mint_request_id() -> str:
    """A fresh request id (``r<pid>-<seq>``).  Always cheap, always
    minted (hibernation keys its host-tier entry by it even when tracing
    is off); sampling only gates what the tracer records for the id."""
    return "r%d-%d" % (os.getpid(), next(_REQ_SEQ))


# -- request context ---------------------------------------------------- #
# A dispatcher that knows which requests ride a call can bind their ids
# to its thread, so layers below it stamp them without taking them as
# arguments.
_REQCTX = threading.local()


def set_request_context(request_ids) -> None:
    """Bind the given request ids to the current thread (the dispatch
    thread) until cleared; tuple-copied so callers can reuse the list."""
    _REQCTX.rids = tuple(request_ids)


def get_request_context() -> tuple:
    """Request ids bound to the current thread (empty when none)."""
    return getattr(_REQCTX, "rids", ())


def clear_request_context() -> None:
    _REQCTX.rids = ()


class _NullSpan:
    """Shared no-op context manager for the disabled path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span; records a Chrome 'X' (complete) event on exit, with
    the thread's CPU time across it when ``cpu``."""
    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_c0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict,
                 cpu: bool = False):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = time.perf_counter()
        self._c0 = time.thread_time_ns() if cpu else None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if exc_type is not None:
            self.args = dict(self.args)
            self.args["error"] = f"{exc_type.__name__}: {exc}"
        self._tracer.add_complete(self.name, self._t0, t1 - self._t0,
                                  cat=self.cat, args=self.args,
                                  cpu_ns0=self._c0)
        return False


class _GcWatch:
    """A ``gc.callbacks`` entry that times each collector pass for one
    tracer.  It holds the tracer weakly, so a tracer dropped while
    enabled is still freed, and records nothing while the tracer is
    disabled or gone."""
    __slots__ = ("_ref", "_t0")

    def __init__(self, tracer: "Tracer"):
        self._ref = weakref.ref(tracer)
        self._t0 = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        t0, self._t0 = self._t0, None
        tracer = self._ref()
        if t0 is None or tracer is None or not tracer.enabled:
            return
        tracer._gc_pass(t0, time.perf_counter() - t0, info)


class Tracer:
    """Ring-buffered trace-event collector.

    One process normally uses the module-level tracer (``get_tracer()``);
    private instances exist for tests and for tools that want an
    isolated buffer.
    """

    def __init__(self, capacity: int = 65536,
                 enabled: Optional[bool] = None,
                 sample_rate: Optional[float] = None):
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        self.sample_rate = (_env_sample_rate() if sample_rate is None
                            else min(max(float(sample_rate), 0.0), 1.0))
        self._events: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._dropped = 0
        # collector passes that found the lock taken (the pass ran inside
        # a locked section, or another thread held it); moved into the
        # ring by the next locked section
        self._gc_pending: deque = deque()
        self._gc_watch: Optional[_GcWatch] = None
        # perf_counter epoch; the unix pair stamps exports with wall time
        self._epoch_perf = time.perf_counter()
        self._epoch_unix = time.time()
        self._pid = os.getpid()

    # -- control -------------------------------------------------------- #
    def enable(self) -> None:
        """Turn tracing on: zero ``dropped`` (when it was off) and time
        the garbage collector's passes (``py/gc``) until ``disable()``."""
        watch = _GcWatch(self)
        with self._lock:
            if not self.enabled:
                self._dropped = 0
            self.enabled = True
            if self._gc_watch is not None:
                return
            self._gc_watch = watch
        gc.callbacks.append(watch)

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            watch, self._gc_watch = self._gc_watch, None
        if watch is not None and watch in gc.callbacks:
            gc.callbacks.remove(watch)

    def set_capacity(self, n: int) -> None:
        """Keep the newest ``n`` events; the older ones a smaller ring
        lets go count as dropped."""
        n = int(n)
        if n < 1:
            raise ValueError(f"a ring holds at least one event, got {n}")
        with self._lock:
            self._flush_gc_locked()
            old = self._events
            self._dropped += max(0, len(old) - n)
            self._events = deque(old, maxlen=n)

    @property
    def dropped(self) -> int:
        """Events a full ring evicted since tracing was turned on."""
        return self._dropped

    def set_sample_rate(self, rate: float) -> None:
        self.sample_rate = min(max(float(rate), 0.0), 1.0)

    def sampled(self, request_id: Optional[str]) -> bool:
        """Whether per-round events should be recorded for this request.

        Deterministic on the id (crc32 fraction vs ``sample_rate``), so
        admission, prefill, decode and failover all make the same call
        without coordinating — a sampled request traces end to end, an
        unsampled one costs nothing anywhere."""
        if not self.enabled or not request_id:
            return False
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        frac = (zlib.crc32(request_id.encode()) & 0xFFFFFFFF) / 2.0 ** 32
        return frac < self.sample_rate

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._gc_pending.clear()

    def __len__(self) -> int:
        with self._lock:
            self._flush_gc_locked()
            return len(self._events)

    # -- recording ------------------------------------------------------ #
    def span(self, name: str, cat: str = "obs", **args):
        """Context manager timing a section.  Disabled: a shared no-op."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def cpu_span(self, name: str, cat: str = "obs", **args):
        """``span`` that also records ``cpu_us``, the thread's CPU time
        across it.  Disabled: the shared no-op."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args, cpu=True)

    def traced(self, name: Optional[str] = None, cat: str = "obs"):
        """Decorator form of ``span`` (span name defaults to the
        function's qualified name)."""
        def deco(fn):
            label = name or fn.__qualname__

            @wraps(fn)
            def wrapper(*a, **kw):
                if not self.enabled:
                    return fn(*a, **kw)
                with self.span(label, cat=cat):
                    return fn(*a, **kw)
            return wrapper
        return deco

    def _ts_us(self, t_perf: float) -> float:
        return (t_perf - self._epoch_perf) * 1e6

    def add_complete(self, name: str, t0_perf: float, dur_s: float,
                     cat: str = "obs", args: Optional[dict] = None,
                     tid: Optional[int] = None,
                     cpu_ns0: Optional[int] = None) -> None:
        """Record a finished span retroactively (``t0_perf`` from
        ``time.perf_counter``) — how the batcher reports a request's
        queue wait it only knows at dispatch time.  With ``cpu_ns0``
        (``time.thread_time_ns()`` at the span's start, on this thread)
        the span carries ``cpu_us``, the thread's CPU time since."""
        if not self.enabled:
            return
        if cpu_ns0 is not None:
            cpu_ns = time.thread_time_ns() - cpu_ns0
            args = dict(args or {})
            args["cpu_us"] = cpu_ns / 1e3
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": self._ts_us(t0_perf), "dur": max(dur_s, 0.0) * 1e6,
              "pid": self._pid,
              "tid": tid if tid is not None else threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._append_locked(ev)

    def instant(self, name: str, cat: str = "obs", **args) -> None:
        """Point-in-time event (Chrome ph='i', thread scope)."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": self._ts_us(time.perf_counter()),
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._append_locked(ev)

    def _append_locked(self, ev: dict) -> None:
        self._flush_gc_locked()
        self._push_locked(ev)

    def _flush_gc_locked(self) -> None:
        while self._gc_pending:
            self._push_locked(self._gc_pending.popleft())

    def _push_locked(self, ev: dict) -> None:
        """Append under the lock, counting what a full ring evicts (by
        the ring's own bound, so a ring swapped in from outside counts
        right too)."""
        ring = self._events
        if len(ring) == ring.maxlen:
            self._dropped += 1
        ring.append(ev)

    def _gc_pass(self, t0_perf: float, dur_s: float, info: dict) -> None:
        """One collector pass, from ``_GcWatch``.  It may run inside any
        allocation, a locked section of this tracer's included, so it
        never waits for the lock: a pass that finds it taken is parked
        and moved into the ring by the next locked section."""
        ev = {"name": "py/gc", "cat": "gc", "ph": "X",
              "ts": self._ts_us(t0_perf), "dur": max(dur_s, 0.0) * 1e6,
              "pid": self._pid, "tid": threading.get_ident(),
              "args": {"generation": info.get("generation"),
                       "collected": info.get("collected")}}
        if self._lock.acquire(blocking=False):
            try:
                self._append_locked(ev)
            finally:
                self._lock.release()
        else:
            self._gc_pending.append(ev)

    # -- reading / export ---------------------------------------------- #
    def events(self) -> list:
        """A snapshot of the ring, ordered by start timestamp.

        Events land in the ring at *completion* time, so under
        concurrent writers the raw append order interleaves
        arbitrarily; sorting by ``ts`` (stable, so equal-ts events keep
        completion order) gives every reader — exports, the flight
        recorder, tests — one canonical ordering.  Each event dict is
        copied under the lock, so a reader never sees a span another
        thread is still assembling."""
        with self._lock:
            self._flush_gc_locked()
            evs = [dict(e) for e in self._events]
        evs.sort(key=lambda e: e.get("ts", 0.0))
        return evs

    @staticmethod
    def _matches_request(ev: dict, request_id: str) -> bool:
        args = ev.get("args")
        if not isinstance(args, dict):
            return False
        if args.get("request_id") == request_id:
            return True
        rids = args.get("request_ids")
        return isinstance(rids, (list, tuple)) and request_id in rids

    def request_events(self, request_id: str) -> list:
        """Every buffered event stamped with this request id — directly
        (``args.request_id``) or as a member of a batch-level event's
        ``args.request_ids`` list."""
        return [e for e in self.events()
                if self._matches_request(e, request_id)]

    def span_tree(self, request_id: str) -> dict:
        """One request's events assembled into a phase tree.

        Spans nest by interval containment (a span whose ``[ts,
        ts+dur]`` lies inside another's is its child), which
        reconstructs the request's lifecycle — queue wait, prefill
        chunks, per-round decode/verify, failover hops — from the flat
        ring without the recorders ever coordinating.  Instants join as
        zero-duration leaves.  Returns ``{"request_id", "span_count",
        "spans": [...]}`` where each span is ``{"name", "cat", "ph",
        "ts", "dur", "args", "children"}``."""
        nodes = []
        for e in sorted(self.request_events(request_id),
                        key=lambda e: (e.get("ts", 0.0),
                                       -e.get("dur", 0.0))):
            nodes.append({"name": e.get("name"), "cat": e.get("cat"),
                          "ph": e.get("ph"), "ts": e.get("ts", 0.0),
                          "dur": e.get("dur", 0.0),
                          "args": e.get("args", {}), "children": []})
        roots: list = []
        stack: list = []
        for n in nodes:
            end = n["ts"] + n["dur"]
            while stack and not (n["ts"] >= stack[-1]["ts"]
                                 and end <= stack[-1]["ts"]
                                 + stack[-1]["dur"]):
                stack.pop()
            (stack[-1]["children"] if stack else roots).append(n)
            if n["ph"] == "X":
                stack.append(n)
        return {"request_id": request_id, "span_count": len(nodes),
                "spans": roots}

    def export_request(self, request_id: str,
                       path: Optional[str] = None) -> dict:
        """One request's events as a Chrome trace-event document —
        the same format ``export_chrome`` writes, filtered to the
        request — written atomically to ``path`` when given."""
        events = self.request_events(request_id)
        doc = {
            "traceEvents": self._thread_metadata(events) + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "bigdl_tpu_torch.obs",
                "epoch_unix": self._epoch_unix,
                "epoch_perf": self._epoch_perf,
                "dropped": self.dropped,
                "request_id": request_id,
            },
        }
        if path:
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        return doc

    def _thread_metadata(self, events: list) -> list:
        """Chrome 'M' thread_name rows so Perfetto shows thread names
        instead of bare idents."""
        names = {t.ident: t.name for t in threading.enumerate()
                 if t.ident is not None}
        rows = []
        for tid in sorted({e["tid"] for e in events}):
            rows.append({"name": "thread_name", "ph": "M", "pid": self._pid,
                         "tid": tid,
                         "args": {"name": names.get(tid, f"thread-{tid}")}})
        return rows

    def export_chrome(self, path: Optional[str] = None) -> dict:
        """The buffered events as a Chrome trace-event document
        (``{"traceEvents": [...]}``); written to ``path`` when given.
        Loadable as-is in Perfetto / chrome://tracing."""
        events = self.events()
        doc = {
            "traceEvents": self._thread_metadata(events) + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "bigdl_tpu_torch.obs",
                "epoch_unix": self._epoch_unix,
                "epoch_perf": self._epoch_perf,
                "dropped": self.dropped,
            },
        }
        if path:
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        return doc

    def export_jsonl(self, path: str) -> int:
        """Structured event log: one JSON object per line (the grep/jq
        side of the same buffer); returns the row count."""
        events = self.events()
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        os.replace(tmp, path)
        return len(events)


#: process-wide tracer — instrumented modules bind this once at import
_GLOBAL = Tracer()
if _GLOBAL.enabled:
    _GLOBAL.enable()        # BIGDL_TPU_TRACE=1: time the collector too


def get_tracer() -> Tracer:
    return _GLOBAL
