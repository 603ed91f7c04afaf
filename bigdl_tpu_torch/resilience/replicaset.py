"""Replica-set failover core (port of the engine-agnostic half of
``bigdl_tpu/resilience/replicaset.py``): the replica states, the
per-replica circuit breaker with its half-open probe, replica selection
under an injectable dispatch policy, and the :class:`HedgePolicy` for
speculative re-dispatch.

A replica that fails is retried elsewhere (bounded re-dispatch), and
repeated failures open its breaker: an open replica takes no traffic
until a cooldown passes, then one half-open probe decides whether it
closes or re-opens.  Health shows in the ``resilience/*`` counters and
gauges of the process-wide registry.  ``serving/router/replicaset.py``
builds the routed LM replica set on this core; the reference's
padded-batch ``ReplicaSet`` (over ``ServingEngine`` and
``DynamicBatcher``) waits for ROADMAP Queue 1 item 11.6.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional

from bigdl_tpu_torch.obs import get_registry

log = logging.getLogger("bigdl_tpu_torch.resilience")

HEALTHY = "healthy"
OPEN = "open"
HALF_OPEN = "half_open"
DRAINING = "draining"


class _Replica:
    __slots__ = ("name", "engine", "state", "inflight", "dispatched",
                 "failures", "consecutive_failures", "opened_at", "slot")

    def __init__(self, name: str, engine, slot=None):
        self.name = name
        self.engine = engine
        self.state = HEALTHY
        self.inflight = 0
        self.dispatched = 0
        self.failures = 0
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self.slot = slot  # a placement slice (none in the port yet)


class HedgePolicy:
    """Spark speculative execution, reborn for serving dispatch.

    BigDL's Spark lineage re-launched straggler tasks on another
    executor and took the first finisher; here the unit is a dispatched
    request: when one has waited longer than a **windowed-p99-based
    trigger** without progress, the set speculatively re-dispatches it
    to the next-best replica, the first completion wins, and the loser
    is cancelled through the cooperative-cancel path.

    Two guardrails keep hedging from amplifying an overload:

    - the trigger is *evidence-based*: no hedge fires until at least
      ``min_observations`` completed waits sit in the rolling window,
      and the trigger is the window's ``trigger_quantile`` (default
      p99) — a straggler is defined by the traffic itself, not a
      hard-coded timeout;
    - a **hedge budget**: fired hedges may never exceed
      ``max_hedge_fraction`` of total dispatches (Spark's
      ``speculation.quantile`` spirit), so the extra load is bounded
      at N% by construction.

    Thread-safe; shared by every dispatch thread of one replica set.
    Counters publish under ``serving/lifecycle/hedges_*``.
    """

    def __init__(self, *, trigger_quantile: float = 0.99,
                 window: int = 256, min_observations: int = 16,
                 max_hedge_fraction: float = 0.05,
                 min_trigger_s: float = 0.0):
        if not 0.0 < trigger_quantile <= 1.0:
            raise ValueError("trigger_quantile must be in (0, 1]")
        if not 0.0 < max_hedge_fraction <= 1.0:
            raise ValueError("max_hedge_fraction must be in (0, 1]")
        self.trigger_quantile = float(trigger_quantile)
        self.window = int(window)
        self.min_observations = int(min_observations)
        self.max_hedge_fraction = float(max_hedge_fraction)
        self.min_trigger_s = float(min_trigger_s)
        self._lock = threading.Lock()
        self._waits: deque = deque(maxlen=self.window)
        self.dispatches = 0
        self.hedges_fired = 0
        self.hedges_won = 0      # the hedge finished first
        self.hedges_lost = 0     # the primary finished first
        reg = get_registry()
        self._c_fired = reg.counter("serving/lifecycle/hedges_fired")
        self._c_won = reg.counter("serving/lifecycle/hedges_won")
        self._c_lost = reg.counter("serving/lifecycle/hedges_lost")

    def note_dispatch(self) -> None:
        with self._lock:
            self.dispatches += 1

    def observe(self, wait_s: float) -> None:
        """Record one completed request's wait (queue-wait / time to
        first progress) into the trigger window."""
        with self._lock:
            self._waits.append(float(wait_s))

    def trigger_s(self) -> Optional[float]:
        """The current hedge trigger (windowed quantile), or None while
        the window holds too little evidence to define a straggler."""
        with self._lock:
            n = len(self._waits)
            if n < self.min_observations:
                return None
            s = sorted(self._waits)
            q = s[min(n - 1, int(self.trigger_quantile * (n - 1)))]
            return max(q, self.min_trigger_s)

    def should_hedge(self, waited_s: float) -> bool:
        """True when ``waited_s`` marks a straggler AND the hedge
        budget (≤ ``max_hedge_fraction`` of dispatches) has room."""
        trig = self.trigger_s()
        if trig is None or waited_s < trig:
            return False
        with self._lock:
            return (self.hedges_fired + 1) <= (
                self.max_hedge_fraction * max(1, self.dispatches))

    def note_fired(self) -> None:
        with self._lock:
            self.hedges_fired += 1
        self._c_fired.add(1)

    def note_outcome(self, hedge_won: bool) -> None:
        with self._lock:
            if hedge_won:
                self.hedges_won += 1
            else:
                self.hedges_lost += 1
        (self._c_won if hedge_won else self._c_lost).add(1)

    def stats(self) -> dict:
        with self._lock:
            return {
                "trigger_quantile": self.trigger_quantile,
                "max_hedge_fraction": self.max_hedge_fraction,
                "window_n": len(self._waits),
                "dispatches": self.dispatches,
                "hedges_fired": self.hedges_fired,
                "hedges_won": self.hedges_won,
                "hedges_lost": self.hedges_lost,
            }

    def snapshot_trigger(self) -> Optional[float]:
        return self.trigger_s()


class ReplicaSetCore:
    """The engine-agnostic half of a replica set: per-replica circuit
    breakers, the half-open probe protocol, and replica selection with
    an **injectable dispatch policy**.

    The LM router's ``LMReplicaSet`` inherits it (as the reference's
    padded-batch ``ReplicaSet`` does, which waits for ROADMAP Queue 1
    item 11.6), so breakers, bounded re-dispatch accounting and the
    pick/record state machine are the reference's.

    ``dispatch_policy`` is ``policy(healthy, ctx) -> replica | None``:
    called under the set lock with the non-excluded HEALTHY replicas
    (half-open probes are arbitrated by the core first — a policy never
    sees, and cannot starve, a probe) and a per-dispatch context dict.
    Returning None — or a replica not in the candidate list — falls
    back to least-loaded, so a policy can only ever *bias* placement,
    never break liveness.  The default (None) is the original
    least-loaded pick: lowest ``inflight``, ties broken by total
    ``dispatched`` so serial traffic round-robins.
    """

    def _init_core(self, *, failure_threshold: int = 3,
                   cooldown_s: float = 5.0,
                   max_redispatch: int = 1,
                   clock=time.monotonic,
                   dispatch_policy=None,
                   hedge_policy: Optional[HedgePolicy] = None) -> None:
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.max_redispatch = int(max_redispatch)
        self._clock = clock
        self.dispatch_policy = dispatch_policy
        # opt-in speculative re-dispatch (Spark speculative execution):
        # None disables hedging entirely
        self.hedge_policy = hedge_policy
        self._lock = threading.Lock()
        self._registry = get_registry()
        self._replicas: list = []

    def _publish_replica_count(self) -> None:
        n = sum(1 for r in self._replicas if r.state != DRAINING)
        self._registry.gauge("resilience/replicas").set(n)

    # ---------------------------------------------------------------- #
    # health / breaker state machine (all transitions under _lock)     #
    # ---------------------------------------------------------------- #
    def _publish_open_circuits(self) -> None:
        n_open = sum(1 for r in self._replicas
                     if r.state in (OPEN, HALF_OPEN))
        self._registry.gauge("resilience/open_circuits").set(n_open)

    def _pick(self, exclude, ctx: Optional[dict] = None) \
            -> Optional[_Replica]:
        """A cooled-down open circuit gets one half-open probe dispatch
        (even while healthy replicas exist — lost capacity must be able
        to return); otherwise the dispatch policy chooses among healthy
        replicas, defaulting to least-loaded with ties broken by total
        work dispatched so serial traffic round-robins."""
        with self._lock:
            candidates = [r for r in self._replicas
                          if r.name not in exclude and r.state != DRAINING]
            pick = None
            if not any(r.state == HALF_OPEN for r in self._replicas):
                now = self._clock()
                for r in candidates:
                    if (r.state == OPEN
                            and now - r.opened_at >= self.cooldown_s):
                        r.state = HALF_OPEN  # one probe in flight at most:
                        # a second probe needs this one to resolve first
                        log.info("replica %s: circuit half-open (probe)",
                                 r.name)
                        pick = r
                        break
            if pick is None:
                healthy = [r for r in candidates if r.state == HEALTHY]
                if healthy:
                    if self.dispatch_policy is not None:
                        pick = self.dispatch_policy(healthy, ctx or {})
                        if pick is not None and pick not in healthy:
                            log.warning(
                                "dispatch policy returned a non-candidate "
                                "replica; falling back to least-loaded")
                            pick = None
                    if pick is None:
                        pick = min(healthy,
                                   key=lambda r: (r.inflight, r.dispatched))
            if pick is not None:
                pick.inflight += 1
                pick.dispatched += 1
            return pick

    def _record_success(self, rep: _Replica) -> None:
        with self._lock:
            rep.inflight -= 1
            rep.consecutive_failures = 0
            if rep.state in (HALF_OPEN, OPEN):
                log.info("replica %s: circuit closed (probe succeeded)",
                         rep.name)
            if rep.state != DRAINING:
                rep.state = HEALTHY
            self._publish_open_circuits()

    def _record_failure(self, rep: _Replica, exc: BaseException) -> None:
        with self._lock:
            rep.inflight -= 1
            rep.failures += 1
            rep.consecutive_failures += 1
            was = rep.state
            if (rep.state == HALF_OPEN
                    or rep.consecutive_failures >= self.failure_threshold):
                rep.state = OPEN
                rep.opened_at = self._clock()
            if rep.state == OPEN and was != OPEN:
                log.warning("replica %s: circuit OPEN after %d consecutive "
                            "failures (%s)", rep.name,
                            rep.consecutive_failures, exc)
            self._publish_open_circuits()
