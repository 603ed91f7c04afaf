"""SLOController: windowed-p99 guardrails that actuate capacity, then
admission (port of ``bigdl_tpu/traffic/slo.py``).

The controller reads latency from the lifetime histograms the engines
already publish (``serving/lm/ttft`` and the like): every tick it
snapshots :meth:`Histogram.counts` and differences it against the
snapshot ``window_intervals`` ticks ago, and
:func:`~bigdl_tpu_torch.obs.registry.percentile_from_counts` turns the
delta into a windowed p99.

The ladder: ``hot_streak`` ticks over target call ``scale_up()`` while
it adds capacity, then step down ``admission_levels`` (a smaller enqueue
bound, typed sheds counted in ``serving/rejected_total``).
``cool_streak`` ticks under target walk back: admission first, capacity
last, and never while the shed window still saw sheds.  :meth:`tick` is
one pure read-decide-actuate step (tests drive it by hand);
:meth:`start`/:meth:`stop` run it on a daemon thread.  The reference's
``ledger=`` (no scale-up past the memory ledger's watermark) waits for
the ledger's port (ROADMAP Queue 1 item 11.6).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, List, Optional, Sequence

from bigdl_tpu_torch.obs.registry import Histogram, percentile_from_counts


class SLOController:
    """Watch one latency histogram; hold its windowed p99 under target.

    Args:
        histogram: a live :class:`~bigdl_tpu_torch.obs.registry.Histogram`
            (an engine's own, e.g. ``LMMetrics.ttft``).
        target_p99_s: the SLO.
        interval_s: tick period when threaded (:meth:`start`).
        window_intervals: sliding window length, in ticks.
        scale_up / scale_down: capacity actuators; ``scale_up`` returns
            truthy when it added capacity (falsy: exhausted, move on to
            admission control).  Wire device-aware hooks
            (``DisaggCoordinator.try_scale_up``, or one gated on
            ``LMServingEngine.kvcache_headroom()``).
        set_admission / admission_levels: the admission actuator and its
            enqueue bounds, loosest first.
        hot_streak / cool_streak: consecutive over- and under-target
            ticks before acting (cool slower than hot on purpose).
        start_level: initial index into ``admission_levels``; a non-zero
            one is applied at once.
        rejections: a callable returning the cumulative shed count; while
            the shed window saw sheds, the controller holds instead of
            relaxing (a healthy p99 under a shut gate is the gate
            working).
        shed_free_intervals: the shed window, in ticks (default
            ``window_intervals``).
    """

    def __init__(self, *, histogram: Histogram, target_p99_s: float,
                 interval_s: float = 0.25,
                 window_intervals: int = 8,
                 scale_up: Optional[Callable[[], object]] = None,
                 scale_down: Optional[Callable[[], object]] = None,
                 set_admission: Optional[Callable[[int], object]] = None,
                 admission_levels: Sequence[int] = (),
                 hot_streak: int = 2,
                 cool_streak: int = 4,
                 start_level: int = 0,
                 rejections: Optional[Callable[[], float]] = None,
                 shed_free_intervals: Optional[int] = None):
        if target_p99_s <= 0:
            raise ValueError("target_p99_s must be > 0")
        if window_intervals < 1:
            raise ValueError("window_intervals must be >= 1")
        self.histogram = histogram
        self.target_p99_s = float(target_p99_s)
        self.interval_s = float(interval_s)
        self.scale_up = scale_up
        self.scale_down = scale_down
        self.set_admission = set_admission
        self.admission_levels = [int(v) for v in admission_levels]
        self.hot_streak = int(hot_streak)
        self.cool_streak = int(cool_streak)

        self.rejections = rejections
        self._snaps: deque = deque(maxlen=window_intervals + 1)
        self._snaps.append(histogram.counts())
        shed_win = (int(shed_free_intervals) if shed_free_intervals
                    else window_intervals)
        self._rej: deque = deque(maxlen=max(1, shed_win) + 1)
        if rejections is not None:
            self._rej.append(float(rejections()))
        self._hot = 0
        self._cool = 0
        # index into admission_levels; 0=loosest
        self._level = (min(max(0, int(start_level)),
                           len(self.admission_levels) - 1)
                       if self.admission_levels else 0)
        if self.set_admission is not None and self._level > 0:
            self.set_admission(self.admission_levels[self._level])
        self._scaling_exhausted = False
        self.actions: List[dict] = []
        self.ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- observation ----------------------------------------------------- #
    def window_p99(self) -> Optional[float]:
        """p99 over the current sliding window; None if the window saw
        no observations (idle is not hot)."""
        new, old = self._snaps[-1], self._snaps[0]
        delta = [max(0, a - b) for a, b in zip(new, old)]
        return percentile_from_counts(delta, 99.0)

    # -- decide + actuate ------------------------------------------------ #
    def tick(self) -> dict:
        """One read-decide-actuate step; returns what it saw and did."""
        self._snaps.append(self.histogram.counts())
        if self.rejections is not None:
            self._rej.append(float(self.rejections()))
        self.ticks += 1
        p99 = self.window_p99()
        action = "none"
        if p99 is not None and p99 > self.target_p99_s:
            self._hot += 1
            self._cool = 0
            if self._hot >= self.hot_streak:
                action = self._tighten()
                self._hot = 0
        elif p99 is not None:
            self._cool += 1
            self._hot = 0
            if self._cool >= self.cool_streak:
                action = self._relax()
                self._cool = 0
        out = {"tick": self.ticks, "p99_s": p99, "action": action,
               "admission_level": self._level,
               "scaling_exhausted": self._scaling_exhausted}
        if action != "none":
            self.actions.append(out)
        return out

    def _tighten(self) -> str:
        if not self._scaling_exhausted and self.scale_up is not None:
            if self.scale_up():
                return "scale_up"
            self._scaling_exhausted = True  # fall through to admission
        if self.set_admission is not None and \
                self._level < len(self.admission_levels) - 1:
            self._level += 1
            self.set_admission(self.admission_levels[self._level])
            return "admission_tighten"
        return "saturated"   # nothing left to pull — sheds do the work

    def _shedding(self) -> bool:
        """True if the current window saw any rejections."""
        return len(self._rej) >= 2 and self._rej[-1] > self._rej[0]

    def _relax(self) -> str:
        if self.rejections is not None and self._shedding():
            # accepted-request p99 is healthy BECAUSE the gate is shut;
            # opening it now would trade typed sheds for queue delay
            return "hold_shedding"
        if self.set_admission is not None and self._level > 0:
            self._level -= 1
            self.set_admission(self.admission_levels[self._level])
            return "admission_relax"
        if self._scaling_exhausted:
            # capacity may have freed up; allow scale_up to retry later
            self._scaling_exhausted = False
            return "rearm_scaling"
        if self.scale_down is not None:
            self.scale_down()
            return "scale_down"
        return "none"

    # -- threading ------------------------------------------------------- #
    def start(self) -> "SLOController":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="slo-controller", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def __enter__(self) -> "SLOController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def summary(self) -> dict:
        return {"ticks": self.ticks,
                "actions": [a["action"] for a in self.actions],
                "admission_level": self._level,
                "admission_value": (self.admission_levels[self._level]
                                    if self.admission_levels else None),
                "scaling_exhausted": self._scaling_exhausted}
