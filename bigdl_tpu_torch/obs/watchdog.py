"""StallWatchdog: turn a silently hung step into a diagnosed event
(port of ``bigdl_tpu/obs/watchdog.py``).

A wedged kernel or a lost card makes a loop look merely "slow".  The
watchdog watches the step cadence: the instrumented loop brackets each
step (``with wd.step(): ...``), a daemon thread tracks the rolling
median of completed durations, and a step exceeding ``k`` x median (or
an absolute ``deadline_s``) fires ONE diagnostics capture:

- :func:`bigdl_tpu_torch.device.diagnose_cuda` under ``diagnose_cuda``
  (the ``/proc`` scan and the memory ledger's last verdict, which never
  call into CUDA, so they are safe while a kernel is wedged);
- all-thread stack dumps (``sys._current_frames``): where the step is
  blocked;
- an instant event into the trace, a log record, and a ``stall`` flight
  bundle when the recorder is armed.

A step on the card is asynchronous: the training loop brackets it up to
the host's read of the loss, so a step's duration is the device's time
and not the launch time.  Firing is once per stall: the flag re-arms
when the step completes.  Env knobs (read by the instrumented call
sites): ``BIGDL_TPU_WATCHDOG`` (default on; ``0`` disables),
``BIGDL_TPU_WATCHDOG_K`` (median multiplier, default 10),
``BIGDL_TPU_WATCHDOG_DEADLINE_S`` (absolute ceiling, default none).
"""
from __future__ import annotations

import logging
import os
import statistics
import sys
import threading
import time
import traceback
from collections import deque
from typing import Callable, Optional

from bigdl_tpu_torch.obs.tracer import get_tracer

log = logging.getLogger("bigdl_tpu_torch.obs")


def env_watchdog_enabled() -> bool:
    return os.environ.get("BIGDL_TPU_WATCHDOG", "1").lower() \
        not in ("0", "false", "off")


def env_watchdog_kwargs() -> dict:
    """k/deadline knobs from the environment (shared by every
    instrumented loop so the knobs are spelled once)."""
    kw = {}
    try:
        kw["k"] = float(os.environ.get("BIGDL_TPU_WATCHDOG_K", "10"))
    except ValueError:
        pass
    dl = os.environ.get("BIGDL_TPU_WATCHDOG_DEADLINE_S")
    if dl:
        try:
            kw["deadline_s"] = float(dl)
        except ValueError:
            pass
    return kw


def thread_stacks(limit_per_thread: int = 40) -> dict:
    """{thread name: formatted stack} for every live thread — where a
    wedged process is actually blocked."""
    names = {t.ident: t.name for t in threading.enumerate()
             if t.ident is not None}
    stacks = {}
    for ident, frame in sys._current_frames().items():
        label = names.get(ident, f"thread-{ident}")
        stacks[label] = "".join(
            traceback.format_stack(frame, limit=limit_per_thread))
    return stacks


class _StepCtx:
    __slots__ = ("_wd",)

    def __init__(self, wd: "StallWatchdog"):
        self._wd = wd

    def __enter__(self):
        self._wd.step_started()
        return self

    def __exit__(self, *exc):
        self._wd.step_finished()
        return False


class StallWatchdog:
    """Rolling-median stall detector for a step/dispatch loop.

    Args:
        name: label for trace events and logs ("train_step", "serve").
        k: fire when the in-flight step exceeds ``k`` x rolling median.
        deadline_s: absolute in-flight ceiling (fires regardless of the
            median; the only trigger before ``min_samples`` completed
            steps exist, so a first-step compile cannot false-fire the
            median rule).
        window: completed-duration history length for the median.
        min_samples: completed steps required before the median rule
            arms (the first steps of a run include compiles).
        poll_s: watcher thread check interval.
        on_stall: optional callback receiving the diagnostics event
            dict (after it is logged and traced).
        capture: extra named capture callables; each result lands under
            its key in the event (defaults to ``diagnose_cuda``).
    """

    def __init__(self, name: str = "step", *, k: float = 10.0,
                 deadline_s: Optional[float] = None, window: int = 64,
                 min_samples: int = 5, poll_s: float = 0.5,
                 tracer=None, on_stall: Optional[Callable] = None,
                 capture: Optional[dict] = None):
        self.name = name
        self.k = float(k)
        self.deadline_s = deadline_s
        self.min_samples = int(min_samples)
        self.poll_s = float(poll_s)
        self.on_stall = on_stall
        self._capture = capture
        self._tracer = tracer if tracer is not None else get_tracer()
        self._durations: deque = deque(maxlen=int(window))
        self._lock = threading.Lock()
        self._inflight_since: Optional[float] = None
        self._fired_inflight = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0
        self.last_event: Optional[dict] = None

    # -- step bracketing ------------------------------------------------ #
    def step(self) -> _StepCtx:
        return _StepCtx(self)

    def reset(self, **overrides) -> "StallWatchdog":
        """Re-arm for a new loop: drop the duration history (a new model
        has a new step time) and apply fresh ``k``/``deadline_s``
        overrides.  How a shared process-wide watchdog is handed from
        one training run to the next."""
        with self._lock:
            self._durations.clear()
            self._inflight_since = None
            self._fired_inflight = False
        if "k" in overrides:
            self.k = float(overrides["k"])
        if "deadline_s" in overrides:
            self.deadline_s = overrides["deadline_s"]
        return self

    def step_started(self) -> None:
        with self._lock:
            self._inflight_since = time.perf_counter()
            self._fired_inflight = False
        self._ensure_thread()

    def step_finished(self) -> None:
        with self._lock:
            if self._inflight_since is not None:
                self._durations.append(
                    time.perf_counter() - self._inflight_since)
            self._inflight_since = None
            self._fired_inflight = False

    def median(self) -> Optional[float]:
        with self._lock:
            if not self._durations:
                return None
            return statistics.median(self._durations)

    # -- detection ------------------------------------------------------ #
    def _threshold(self) -> Optional[float]:
        """Current fire threshold in seconds, None when unarmed."""
        with self._lock:
            n = len(self._durations)
            med = statistics.median(self._durations) if n else None
        bounds = []
        if med is not None and n >= self.min_samples:
            bounds.append(self.k * med)
        if self.deadline_s is not None:
            bounds.append(self.deadline_s)
        return min(bounds) if bounds else None

    def check_now(self) -> Optional[dict]:
        """Synchronous probe (what the watcher thread runs each poll):
        fires and returns the diagnostics event when the in-flight step
        is past threshold, else None."""
        with self._lock:
            since = self._inflight_since
            fired = self._fired_inflight
        if since is None or fired:
            return None
        inflight = time.perf_counter() - since
        threshold = self._threshold()
        if threshold is None or inflight < threshold:
            return None
        with self._lock:
            if self._fired_inflight:  # lost the race to another poller
                return None
            self._fired_inflight = True
        return self._fire(inflight, threshold)

    def _fire(self, inflight_s: float, threshold_s: float) -> dict:
        event = {
            "kind": "stall", "watchdog": self.name,
            "inflight_s": round(inflight_s, 3),
            "threshold_s": round(threshold_s, 3),
            "median_s": self.median(),
            "steps_observed": len(self._durations),
        }
        captures = self._capture
        if captures is None:
            captures = {"diagnose_cuda": _default_diagnose}
        for key, fn in captures.items():
            try:
                event[key] = fn()
            except Exception as e:  # diagnostics must never kill the loop
                event[key] = f"capture failed: {e}"
        event["thread_stacks"] = thread_stacks()
        self.stall_count += 1
        self.last_event = event
        log.error(
            "watchdog %s: step in flight %.1fs exceeds threshold %.1fs "
            "(median %s); diagnose_cuda: %s", self.name, inflight_s,
            threshold_s, event["median_s"], event.get("diagnose_cuda"))
        tr = self._tracer
        # instant event regardless of prior state: a stall is exactly
        # when a trace must exist, so firing force-enables the buffer
        # for this event if tracing was off
        was = tr.enabled
        tr.enabled = True
        try:
            tr.instant(f"stall:{self.name}", cat="watchdog", **{
                k: v for k, v in event.items() if k != "thread_stacks"})
        finally:
            tr.enabled = was
        if self.on_stall is not None:
            try:
                self.on_stall(event)
            except Exception:
                log.exception("watchdog on_stall callback failed")
        # a stall is a first-class incident: dump the correlated bundle
        # (last spans + time-series window + the diagnostics captured
        # above) if the process flight recorder is armed
        try:
            from bigdl_tpu_torch.obs import flight
            flight.get_flight_recorder().record(
                "stall",
                {k: v for k, v in event.items() if k != "thread_stacks"},
                key=self.name)
        except Exception:
            log.exception("watchdog flight-recorder dump failed")
        return event

    # -- watcher thread ------------------------------------------------- #
    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._watch, daemon=True,
            name=f"bigdl-torch-watchdog-{self.name}")
        self._thread.start()

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check_now()
            except Exception:  # never let the watcher die silently
                log.exception("watchdog poll failed")

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2 * self.poll_s + 1.0)
        self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def _default_diagnose() -> str:
    from bigdl_tpu_torch.device import diagnose_cuda
    return diagnose_cuda()


_SHARED: dict = {}
_shared_lock = threading.Lock()


def shared_watchdog(name: str) -> StallWatchdog:
    """Process-wide watchdog per loop name, created on first use with
    the env knobs.  Long-lived on purpose: the poll thread is one
    daemon per loop kind, and successive training runs re-arm it with
    ``reset()`` instead of spawning/joining threads per run."""
    with _shared_lock:
        wd = _SHARED.get(name)
        if wd is None:
            wd = StallWatchdog(name, **env_watchdog_kwargs())
            _SHARED[name] = wd
        return wd
