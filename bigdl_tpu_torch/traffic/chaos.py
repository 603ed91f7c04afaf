"""Chaos replay: turn the recorded incident log into a live fault
schedule and fire it mid-load (port of ``bigdl_tpu/traffic/chaos.py``).

Two halves:

- :func:`build_schedule`: a deterministic (seeded) bootstrap resample of
  the log's inter-incident gaps, compressed onto the requested window,
  each event mapped to a fault site of the port's LM engine by what the
  incident's stage was exercising when it died.  The draws are the
  reference's, draw for draw, so one log and one seed give the same
  times and source rows in both packages; two sites differ, because the
  port's engine has no ``engine.init`` or ``serving.dispatch`` site:
  :data:`PORT_SITES` maps them.
- :class:`ChaosReplayer`: arms an (initially empty) FaultInjector and
  appends each event's spec at its scheduled offset, so faults land
  while requests are in flight.  Arming sets ``BIGDL_TPU_FAULTS`` (to
  the full schedule, visible to ``ps e``) and refuses to clobber an
  operator's explicit spec.

The contract asserted on top of it: zero accepted-request loss, every
request the engine accepted completes with exact results; only typed
sheds at admission may increase.
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import List, Optional

from bigdl_tpu_torch.resilience.faults import (ENV_SPEC, FaultInjector,
                                               active, install, parse_spec)
from bigdl_tpu_torch.traffic.incidents import (DEFAULT_PATH,
                                               inter_incident_gaps,
                                               load_incidents)

#: fallback inter-incident gap (seconds) when the log is empty or has a
#: single row (the reference's value).
DEFAULT_GAP_S = 600.0

#: the reference's sites that the port's LM engine does not cross, and
#: the port's site each replays at: a bring-up death becomes an
#: admission wobble (a typed shed), a death mid-dispatch a fault in the
#: verify round (the round demotes to plain decode, streams stay exact)
PORT_SITES = {"engine.init": "serving.enqueue",
              "serving.dispatch": "serving.verify"}


def _map_incident(incident: dict) -> tuple:
    """(site, kind) an incident replays at, on the port's sites.

    The reference's rule: a clean-exit row (rc=0) replays as a transient
    at admission; a deadline, cancel or disconnect stage as a client
    cancel; an LM-serving stage death mid-dispatch; every other hard
    death on the transfer path; probe and init deaths at bring-up.
    :data:`PORT_SITES` then moves the last two onto the port's LM
    engine: ``serving.verify`` and ``serving.enqueue``."""
    site, kind = _reference_site(incident)
    return PORT_SITES.get(site, site), kind


def _reference_site(incident: dict) -> tuple:
    """The reference's (site, kind) for one incident row."""
    stage = str(incident.get("stage", "")).lower()
    rc = int(incident.get("rc", 1))
    if "probe" in stage or "init" in stage:
        return "engine.init", "transient"
    if "deadline" in stage or "cancel" in stage or "disconnect" in stage:
        # lifecycle-stage incidents replay as client disconnects: the
        # serving.cancel site turns any injected fault into a
        # cooperative stream.cancel at the next scheduler round
        return "serving.cancel", "transient"
    if rc == 0:
        return "serving.enqueue", "transient"
    if "lm" in stage or "serv" in stage:
        return "serving.dispatch", "transient"
    return "transfer.chunk", "transient"


def build_schedule(duration_s: float, *,
                   incidents: Optional[List[dict]] = None,
                   path: str = DEFAULT_PATH,
                   seed: int = 0,
                   min_events: int = 2,
                   max_events: int = 16) -> List[dict]:
    """Seeded chaos schedule for a ``duration_s`` window.

    Gaps are bootstrap-resampled from the empirical inter-incident
    distribution and compressed onto the window preserving their
    relative structure (a run of short real gaps stays a burst of
    chaos events); each event inherits (site, kind) from a resampled
    incident via :func:`_map_incident`.  Deterministic in
    (incident log, duration, seed), and equal to the reference's
    schedule up to :data:`PORT_SITES`."""
    if duration_s <= 0:
        raise ValueError("duration_s must be > 0")
    if incidents is None:
        incidents = load_incidents(path)
    gaps = inter_incident_gaps(incidents) or [DEFAULT_GAP_S]
    rng = random.Random(int(seed))
    mean_gap = sum(gaps) / len(gaps)
    n = int(round(duration_s / mean_gap)) if mean_gap > 0 else 0
    n = max(min_events, min(max_events, n if n > 0 else min_events))
    drawn_gaps = [rng.choice(gaps) for _ in range(n)]
    drawn_rows = ([rng.choice(incidents) for _ in range(n)]
                  if incidents else [{"stage": "bench", "rc": 124}] * n)
    # compress: n gaps + a tail gap span the window, so every event
    # lands strictly inside it
    total = sum(drawn_gaps) + rng.choice(gaps)
    events, at = [], 0.0
    for gap, row in zip(drawn_gaps, drawn_rows):
        at += gap * duration_s / total
        site, kind = _map_incident(row)
        events.append({
            "at_s": round(at, 4),
            "site": site,
            "kind": kind,
            "spec": f"{site}:{kind}:count=1",
            "source_stage": row.get("stage"),
            "source_rc": row.get("rc"),
        })
    return events


class ChaosReplayer:
    """Fire a :func:`build_schedule` schedule against the live process.

    ``start()`` arms an empty injector (honouring the ``BIGDL_TPU_FAULTS``
    interlock) and a daemon thread appends each event's spec at its
    scheduled offset; ``stop()`` disarms and restores the env.  Specs
    land with ``count=1``, so each event injects exactly one fault at
    the next matching hook-point crossing — a dead window (no traffic
    at that site) leaves the spec armed, as a real backend death
    waits for the next transfer to surface.
    """

    def __init__(self, schedule: List[dict], *, seed: int = 0):
        self.schedule = sorted(schedule, key=lambda e: e["at_s"])
        self.seed = int(seed)
        self.injector: Optional[FaultInjector] = None
        self.armed_events: List[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._env_was_set = False

    def start(self) -> "ChaosReplayer":
        if self._thread is not None:
            return self
        if os.environ.get(ENV_SPEC):
            raise RuntimeError(
                f"{ENV_SPEC} is already set — refusing to replace an "
                "explicit fault spec with a chaos schedule")
        if active() is not None:
            raise RuntimeError("a FaultInjector is already installed")
        # the env var shows the FULL schedule: chaos is visible, and the
        # install() interlock stays honest
        os.environ[ENV_SPEC] = ";".join(e["spec"] for e in self.schedule) \
            or "serving.enqueue:transient:count=0"
        self.injector = FaultInjector([], seed=self.seed)
        install(self.injector)
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="chaos-replayer", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        t0 = time.monotonic()
        for ev in self.schedule:
            lag = ev["at_s"] - (time.monotonic() - t0)
            if lag > 0 and self._stop.wait(lag):
                return
            if self._stop.is_set():
                return
            # appending to the live spec list is how events "happen":
            # the next matching fault_point crossing fires them
            self.injector.specs.extend(parse_spec(ev["spec"]))
            self.armed_events.append(
                dict(ev, armed_at_s=round(time.monotonic() - t0, 4)))

    def stop(self) -> "ChaosReplayer":
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        if self.injector is not None and active() is self.injector:
            install(None)
        os.environ.pop(ENV_SPEC, None)
        return self

    def __enter__(self) -> "ChaosReplayer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def summary(self) -> dict:
        inj = self.injector
        return {
            "scheduled": len(self.schedule),
            "armed": len(self.armed_events),
            "fired": (sum(v["fired"] for v in inj.stats().values())
                      if inj else 0),
            "events": [{k: e.get(k) for k in
                        ("at_s", "site", "kind", "source_stage")}
                       for e in self.schedule],
        }
