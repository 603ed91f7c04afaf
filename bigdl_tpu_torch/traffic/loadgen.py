"""TraceLoadGenerator: open-loop, deterministic, production-shaped load
(port of ``bigdl_tpu/traffic/loadgen.py``).

The honest overload model is OPEN-LOOP: arrivals are a property of the
outside world and never wait on completions.  A closed-loop client
(submit, wait, submit) self-throttles exactly when the server saturates
— it can never show the saturation knee, because its offered load
collapses to the server's capacity.  ``run()`` therefore replays a
pre-computed arrival schedule on the wall clock and keeps submitting
whether or not anything has finished; a saturated server answers with
the typed shed (:class:`~bigdl_tpu_torch.resilience.errors.ServingOverloaded`)
and the report separates accepted / shed / errored.

Traces are deterministic given (kind, rate, duration, seed), and the
draws are numpy ``RandomState``'s, in the reference's order: one
configuration gives the same trace, arrival for arrival, in both
packages.

- ``poisson``  — homogeneous Poisson arrivals at ``rate_rps``.
- ``bursty``   — on/off modulated Poisson (thinning): during a burst
  the rate is ``burst_factor`` x, between bursts it is scaled down so
  the MEAN offered rate stays ``rate_rps``.
- ``diurnal``  — a day compressed into the trace: the rate ramps
  ``floor -> peak -> floor`` as a half-sine, peak = ``rate_rps``.

Every arrival also carries a prompt (seeded ids) and a generation
budget drawn from the configured menus: mixed prompt and output lengths
are what make continuous batching earn its keep.
"""
from __future__ import annotations

import math
import time
from typing import Callable, List, Optional

import numpy as np

from bigdl_tpu_torch.resilience.errors import ServingOverloaded

KINDS = ("poisson", "bursty", "diurnal")


class Arrival:
    """One scheduled request: submit at ``at_s`` after trace start.

    ``deadline_s`` / ``cancel_after_s`` are the request's LIFECYCLE
    shape: the wall-clock budget the client attaches at enqueue and the
    instant (after submit) the client walks away — both drawn from
    seeded menus like prompt/max_new, both None when the trace carries
    no lifecycle traffic.  They describe client behavior, so the
    generator only records them; honoring them is the server's job."""

    __slots__ = ("index", "at_s", "prompt", "max_new", "deadline_s",
                 "cancel_after_s")

    def __init__(self, index: int, at_s: float, prompt: np.ndarray,
                 max_new: int, deadline_s: Optional[float] = None,
                 cancel_after_s: Optional[float] = None):
        self.index = index
        self.at_s = at_s
        self.prompt = prompt        # (t,) int32, 1-based ids
        self.max_new = max_new
        self.deadline_s = deadline_s
        self.cancel_after_s = cancel_after_s

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def __repr__(self):  # pragma: no cover - debugging nicety
        extra = ""
        if self.deadline_s is not None:
            extra += f", deadline={self.deadline_s:.3f}s"
        if self.cancel_after_s is not None:
            extra += f", cancel_after={self.cancel_after_s:.3f}s"
        return (f"Arrival({self.index}, at={self.at_s:.3f}s, "
                f"t={self.prompt_len}, max_new={self.max_new}{extra})")


class LoadReport:
    """What one open-loop replay produced.  ``accepted`` pairs each
    arrival with whatever handle ``submit`` returned (an LMStream, a
    Future, ...); completions are the CALLER's business — the generator
    never waits on them."""

    def __init__(self, offered: int):
        self.offered = offered
        self.accepted: list = []     # (Arrival, handle)
        self.shed: List[int] = []    # arrival indices typed-rejected
        self.errors: list = []       # (index, repr(exc)) — NOT overload
        self.duration_s = 0.0

    def summary(self) -> dict:
        return {
            "offered": self.offered,
            "accepted": len(self.accepted),
            "shed": len(self.shed),
            "errors": len(self.errors),
            "duration_s": round(self.duration_s, 3),
            "offered_rps": (round(self.offered / self.duration_s, 2)
                            if self.duration_s > 0 else None),
        }


class TraceLoadGenerator:
    """Deterministic seeded arrival traces + the open-loop replayer.

    Args:
        kind: ``poisson`` | ``bursty`` | ``diurnal``.
        rate_rps: mean offered rate (poisson/bursty) or peak (diurnal).
        duration_s: trace length.
        seed: trace RNG seed — same (kind, rate, duration, seed,
            menus) is the same trace, arrival for arrival.
        vocab: 1-based id range for generated prompts.
        prompt_lens / max_news: menus the per-arrival lengths are drawn
            from (uniform, seeded).
        burst_factor / burst_period_s / burst_duty: bursty shape — a
            ``burst_duty`` fraction of every period runs at
            ``burst_factor`` x the mean rate.
        diurnal_floor: trough rate as a fraction of the peak.
        deadline_menu: per-request wall-clock budgets (seconds) drawn
            uniformly like the prompt/max_new menus; entries of None
            mean "no deadline" so a menu can mix bounded and unbounded
            traffic.  Empty/None menu (default): no deadlines at all.
        deadline_fraction: probability an arrival draws from
            ``deadline_menu`` at all (seeded), letting a trace carry a
            minority of deadline-bound requests.
        cancel_after_menu / cancel_fraction: same shape for client
            disconnects — ``cancel_after_s`` seconds after submit the
            client stops listening (the caller calls
            ``stream.cancel()``).
    """

    def __init__(self, *, kind: str = "poisson",
                 rate_rps: float = 8.0,
                 duration_s: float = 5.0,
                 seed: int = 0,
                 vocab: int = 256,
                 prompt_lens=(8, 24, 48),
                 max_news=(16, 32, 48),
                 burst_factor: float = 3.0,
                 burst_period_s: float = 2.0,
                 burst_duty: float = 0.3,
                 diurnal_floor: float = 0.2,
                 deadline_menu=None,
                 deadline_fraction: float = 1.0,
                 cancel_after_menu=None,
                 cancel_fraction: float = 1.0):
        if kind not in KINDS:
            raise ValueError(f"unknown trace kind {kind!r} "
                             f"(expected one of {KINDS})")
        if rate_rps <= 0 or duration_s <= 0:
            raise ValueError("rate_rps and duration_s must be > 0")
        if not (0.0 < burst_duty < 1.0):
            raise ValueError("burst_duty must be in (0, 1)")
        if burst_factor * burst_duty >= 1.0 and kind == "bursty" \
                and burst_factor < 1.0:
            raise ValueError("burst_factor must be >= 1")
        self.kind = kind
        self.rate_rps = float(rate_rps)
        self.duration_s = float(duration_s)
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.prompt_lens = tuple(int(t) for t in prompt_lens)
        self.max_news = tuple(int(m) for m in max_news)
        self.burst_factor = float(burst_factor)
        self.burst_period_s = float(burst_period_s)
        self.burst_duty = float(burst_duty)
        self.diurnal_floor = float(diurnal_floor)
        if not (0.0 <= deadline_fraction <= 1.0):
            raise ValueError("deadline_fraction must be in [0, 1]")
        if not (0.0 <= cancel_fraction <= 1.0):
            raise ValueError("cancel_fraction must be in [0, 1]")
        self.deadline_menu = (None if not deadline_menu else tuple(
            (None if d is None else float(d)) for d in deadline_menu))
        self.deadline_fraction = float(deadline_fraction)
        self.cancel_after_menu = (None if not cancel_after_menu else tuple(
            (None if c is None else float(c)) for c in cancel_after_menu))
        self.cancel_fraction = float(cancel_fraction)

    def config(self) -> dict:
        """Everything that determines the trace — artifact row header."""
        return {"kind": self.kind, "rate_rps": self.rate_rps,
                "duration_s": self.duration_s, "seed": self.seed,
                "vocab": self.vocab,
                "prompt_lens": list(self.prompt_lens),
                "max_news": list(self.max_news),
                "burst_factor": self.burst_factor,
                "burst_period_s": self.burst_period_s,
                "burst_duty": self.burst_duty,
                "diurnal_floor": self.diurnal_floor,
                "deadline_menu": (list(self.deadline_menu)
                                  if self.deadline_menu else None),
                "deadline_fraction": self.deadline_fraction,
                "cancel_after_menu": (list(self.cancel_after_menu)
                                      if self.cancel_after_menu else None),
                "cancel_fraction": self.cancel_fraction}

    # -- rate shape ----------------------------------------------------- #
    def _rate_at(self, t: float) -> float:
        if self.kind == "poisson":
            return self.rate_rps
        if self.kind == "bursty":
            phase = (t % self.burst_period_s) / self.burst_period_s
            if phase < self.burst_duty:
                return self.rate_rps * self.burst_factor
            # off-phase scaled so the mean over a period stays rate_rps
            off = (1.0 - self.burst_factor * self.burst_duty) \
                / (1.0 - self.burst_duty)
            return self.rate_rps * max(0.0, off)
        # diurnal: floor -> peak -> floor half-sine over the trace
        frac = min(max(t / self.duration_s, 0.0), 1.0)
        shape = self.diurnal_floor + (1.0 - self.diurnal_floor) \
            * math.sin(math.pi * frac)
        return self.rate_rps * shape

    def _peak_rate(self) -> float:
        if self.kind == "bursty":
            return self.rate_rps * max(self.burst_factor, 1.0)
        return self.rate_rps

    # -- trace ---------------------------------------------------------- #
    def trace(self) -> List[Arrival]:
        """The full deterministic schedule (Lewis-Shedler thinning of a
        homogeneous Poisson process at the peak rate)."""
        rng = np.random.RandomState(self.seed)
        peak = self._peak_rate()
        arrivals: List[Arrival] = []
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / peak))
            if t >= self.duration_s:
                break
            if float(rng.random_sample()) >= self._rate_at(t) / peak:
                continue  # thinned out
            pl = self.prompt_lens[int(rng.randint(len(self.prompt_lens)))]
            mn = self.max_news[int(rng.randint(len(self.max_news)))]
            prompt = rng.randint(1, self.vocab + 1, size=pl) \
                .astype(np.int32)
            # lifecycle draws ALWAYS consume RNG when a menu is set, so
            # a trace's prompts/timings are identical whether a given
            # arrival ends up bounded or not (same seed, same trace)
            dl = None
            if self.deadline_menu:
                pick = self.deadline_menu[
                    int(rng.randint(len(self.deadline_menu)))]
                take = float(rng.random_sample()) < self.deadline_fraction
                dl = pick if take else None
            ca = None
            if self.cancel_after_menu:
                pick = self.cancel_after_menu[
                    int(rng.randint(len(self.cancel_after_menu)))]
                take = float(rng.random_sample()) < self.cancel_fraction
                ca = pick if take else None
            arrivals.append(Arrival(len(arrivals), t, prompt, mn,
                                    deadline_s=dl, cancel_after_s=ca))
        return arrivals

    # -- open-loop replay ------------------------------------------------ #
    def run(self, submit: Callable[[Arrival], object], *,
            clock=time.perf_counter, sleep=time.sleep,
            trace: Optional[List[Arrival]] = None) -> LoadReport:
        """Replay the schedule against ``submit(arrival) -> handle``.

        Open-loop: each arrival fires at its scheduled wall-clock time
        whether or not earlier requests completed.  ``submit`` must not
        block (both serving queues append-and-return; a full queue
        raises instead of blocking, which is the point).  A
        ``ServingOverloaded`` counts as shed; any other exception is
        recorded as an error and the replay continues."""
        sched = self.trace() if trace is None else trace
        report = LoadReport(offered=len(sched))
        t0 = clock()
        for a in sched:
            lag = a.at_s - (clock() - t0)
            if lag > 0:
                sleep(lag)
            try:
                handle = submit(a)
            except ServingOverloaded:
                report.shed.append(a.index)
                continue
            except Exception as e:  # noqa: BLE001 — accounted, not fatal
                report.errors.append((a.index, repr(e)))
                continue
            report.accepted.append((a, handle))
        report.duration_s = clock() - t0
        return report
