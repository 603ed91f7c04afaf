"""Multi-replica serving failover (port of
``bigdl_tpu/resilience/replicaset.py``): the replica states, the
per-replica circuit breaker with its half-open probe, replica selection
under an injectable dispatch policy, the :class:`HedgePolicy` for
speculative re-dispatch, and the padded-batch :class:`ReplicaSet`: N
``ServingEngine`` replicas behind ONE ``DynamicBatcher``.

A replica that fails is retried elsewhere (bounded re-dispatch), and
repeated failures open its breaker: an open replica takes no traffic
until a cooldown passes, then one half-open probe decides whether it
closes or re-opens.  Health shows in the ``resilience/*`` counters and
gauges of the process-wide registry.  ``serving/router/replicaset.py``
builds the routed LM replica set on this core, and :class:`ReplicaSet`
the padded-batch one.  Its members are ``ServingEngine`` replicas built
with ``with_batcher=False`` (one queue for the set), each with its own
graph cache, stager and watchdog bracket.  As in the reference, the
padded-batch set does not hedge (its core's ``hedge_policy`` stays
None): a batch is re-dispatched only after a failure.  Under a
``PlacementPolicy`` each replica holds one slot.  A set whose policy has
slots on other ranks of a process world runs *forwarded*
(``serving.placement.forward``): every rank builds it with the same
arguments and closes it, world rank 0 (the driver) takes every request,
and a replica on other ranks is a handle whose ``_run_batch`` carries
the padded batch to its slot's ranks and returns the lead rank's rows.
Those ranks run the real ``ServingEngine._run_batch`` (its
``serving.dispatch`` fault site included); an error comes back as its
class, so the breaker counts a remote failure as a local one, and a
reply that never comes is the replica's death.
"""
from __future__ import annotations

import functools
import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

from bigdl_tpu_torch.obs import get_registry
from bigdl_tpu_torch.resilience.errors import BackendLostError, classify_error

log = logging.getLogger("bigdl_tpu_torch.resilience")


def _forward():
    # serving imports this module: the placement package is imported late
    from bigdl_tpu_torch.serving.placement import forward
    return forward

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
        self.slot = slot  # the replica's MeshSlice under placement


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

    The LM router's ``LMReplicaSet`` and the padded-batch
    :class:`ReplicaSet` inherit it, so breakers, bounded re-dispatch
    accounting and the pick/record state machine are the reference's.

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


class _ForwardedEngine:
    """The driver's handle on a forwarded replica (see the module
    docstring): its slot's ranks hold the engine (the driver among them
    when it holds the slot: its engine then runs on the channel's
    executor like theirs).  Each batch goes to the slot's ranks in the
    channel's order, and the lead rank's rows come back."""

    def __init__(self, name: str, link):
        self.name = name
        self.link = link
        self.cache = self

    @functools.cached_property
    def _desc(self) -> dict:
        return self.link.control("describe")

    @property
    def input_shape(self):
        return self._desc["input_shape"]

    @property
    def max_batch_size(self) -> int:
        return self._desc["max_batch_size"]

    @property
    def buckets(self) -> tuple:
        return tuple(self._desc["buckets"])

    def stats(self) -> dict:
        """The remote engine's graph-cache stats (this handle stands in
        for its ``cache``)."""
        return self.link.call("cache_stats")

    def _coerce(self, x, batched: bool) -> np.ndarray:
        x = np.asarray(x, np.dtype(self._desc["dtype"]))
        return x if batched else x[None]

    def _run_batch(self, x_padded: np.ndarray):
        return self.link.call("run", x_padded)

    def warmup(self, input_shape: Optional[tuple] = None) -> int:
        n = self.link.control("warmup", input_shape)
        self.__dict__.pop("_desc", None)   # the input shape may be set now
        return n

    def close(self, timeout: Optional[float] = None) -> None:
        """The replica leaves its slot (the channel stays, for a later
        replica there)."""
        self.link.control("drop")


class ReplicaSet(ReplicaSetCore):
    """Serve a built module from ``n_replicas`` engines with failover.

    Args:
        module: a built ``nn.Module`` — every replica freezes the same
            params, so replica-set outputs are exactly the single-engine
            outputs (the acceptance contract) — OR a sequence of built
            modules, one per replica (heterogeneous sets: e.g. a
            ``Module.quantize()`` int8 clone next to its f32 original;
            each engine keys its compile cache on its own params dtype).
            With heterogeneous members the failover contract is
            per-replica exactness: a request's output is exactly what
            the replica that served it would produce alone.
        n_replicas: how many ServingEngine replicas to build (default 2,
            or ``len(module)`` when a sequence is given).
        failure_threshold: consecutive failures that open a replica's
            circuit.
        cooldown_s: how long an open circuit waits before a half-open
            probe is allowed.
        max_redispatch: how many times one batch may be re-dispatched
            after a failure before the set gives up (default: try every
            replica once).
        dispatch_policy: optional replica-selection policy (see
            :class:`ReplicaSetCore`) — e.g. the serving router's
            prefix-affinity scorer.  None keeps least-loaded.
        clock: injectable monotonic clock (tests drive breaker timing).
        placement: optional
            :class:`~bigdl_tpu_torch.serving.placement.PlacementPolicy`:
            one replica = one slot.  Every member engine is built on its
            own acquired :class:`MeshSlice` (params staged onto it,
            tensor-parallel across a ``tp > 1`` slot's ranks),
            ``scale_to`` acquires and releases slots, and growth past
            the policy's headroom is refused instead of oversubscribing
            devices (see :meth:`try_scale_up`).  Slots on other ranks of
            a process world make the set forwarded (see the module
            docstring): build and close it on every rank, submit on rank
            0.  Without a world such a slot raises ``PlacementError``.
        Remaining kwargs mirror :class:`ServingEngine` / DynamicBatcher
        policy knobs (``device=`` among them: default the card).
    """

    def __init__(self, module, n_replicas: Optional[int] = None, *,
                 failure_threshold: int = 3,
                 cooldown_s: float = 5.0,
                 max_redispatch: Optional[int] = None,
                 dispatch_policy=None,
                 clock=time.monotonic,
                 input_shape: Optional[tuple] = None,
                 buckets: Optional[Sequence[int]] = None,
                 max_batch_size: Optional[int] = None,
                 max_wait_ms: float = 5.0,
                 max_queue: int = 256,
                 dtype="float32",
                 platform: Optional[str] = None,
                 use_shared_pool: bool = True,
                 placement=None,
                 **engine_kwargs):
        modules = (list(module) if isinstance(module, (list, tuple))
                   else None)
        if modules is not None:
            if n_replicas is None:
                n_replicas = len(modules)
            elif n_replicas != len(modules):
                raise ValueError(
                    f"{len(modules)} modules given but n_replicas="
                    f"{n_replicas}: pass one module per replica")
        elif n_replicas is None:
            n_replicas = 2
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        from bigdl_tpu_torch.serving.batcher import DynamicBatcher
        from bigdl_tpu_torch.serving.engine import ServingEngine
        from bigdl_tpu_torch.serving.metrics import ServingMetrics
        from bigdl_tpu_torch.utils.engine import Engine

        self._init_core(
            failure_threshold=failure_threshold,
            cooldown_s=cooldown_s,
            max_redispatch=(int(max_redispatch) if max_redispatch
                            is not None else max(1, n_replicas - 1)),
            clock=clock, dispatch_policy=dispatch_policy)
        # kept for scale_to(): new replicas are built from the same
        # module (heterogeneous sets grow with their FIRST module) and
        # the same engine policy the constructor used
        self._modules = modules
        self._scale_module = modules[0] if modules is not None else module
        self._engine_cls = ServingEngine
        self._engine_cfg = dict(input_shape=input_shape, buckets=buckets,
                                max_batch_size=max_batch_size, dtype=dtype,
                                platform=platform, **engine_kwargs)
        self.placement = placement
        self._next_idx = n_replicas
        self._replicas = []
        # forwarded (see the module docstring): this rank's share of the
        # world; a rank other than the driver (a follower) keeps no
        # replicas, only its engines of the slots that hold it and the
        # slots it acquired
        self._fw = (_forward().Forwarding(placement, self._build)
                    if _forward().forwarded(placement) else None)
        self._follower = self._fw is not None and not self._fw.driver
        held, err = [], None
        try:
            for i in range(n_replicas):
                slot = None
                if placement is not None:
                    slot = self._acquire_slot(required=True)
                    held.append(slot)
                engine = self._engine_for(f"r{i}", slot, i)
                if engine is not None:
                    self._replicas.append(_Replica(f"r{i}", engine,
                                                   slot=slot))
        except BaseException as e:
            err = e
        if self._fw is not None:
            # every rank's outcome: one rank's failure fails every rank
            err = self._fw.settle(err)
        if err is not None:
            # give back every slot taken: the built replicas' and one
            # whose engine failed (a handle's engine is its ranks' own)
            for r in self._replicas:
                if not isinstance(r.engine, _ForwardedEngine):
                    r.engine.close()
            if self._fw is not None:
                self._fw.close_engines()
            for s in held:
                placement.release(s)
            raise err
        self._held = held if self._follower else []
        self._closed = False
        if self._follower:
            self.batcher = self.metrics = None
            return
        ref = self._replicas[0].engine
        # a tensor-parallel slot's ranks dispatch the same batches (in a
        # forwarded set only the driver's batcher takes requests)
        lead = None if self._fw is not None else self._replicas[0].slot
        # one batching policy for the whole set, published as the
        # process's serving/* metrics (created after the member engines
        # so the set owns the names)
        self.metrics = ServingMetrics().publish_to(self._registry)
        self.batcher = DynamicBatcher(
            self._dispatch_batch,
            max_batch_size=ref.max_batch_size,
            max_wait_ms=max_wait_ms,
            max_queue=max_queue,
            buckets=ref.buckets,
            metrics=self.metrics,
            pool=Engine.default_or_create() if use_shared_pool else None,
            lockstep=lead.lockstep() if lead is not None else None)
        self._publish_open_circuits()
        self._publish_replica_count()
        # flight-recorder state: circuit states + pending depth land in
        # every incident bundle (weakref — a closed set must be
        # collectable; latest set wins the key)
        try:
            import weakref

            from bigdl_tpu_torch.obs import flight
            wself = weakref.ref(self)

            def _flight_state():
                rs = wself()
                return rs.stats() if rs is not None else None
            flight.register_state("replicaset", _flight_state)
        except Exception:
            pass

    def _acquire_slot(self, *, required: bool):
        """One slot from the placement policy; raises (required) or
        returns None (opportunistic growth) when the device set is fully
        packed.  A slot on other ranks with no process world running
        raises ``PlacementError`` either way."""
        from bigdl_tpu_torch.serving.placement import PlacementError
        slot = self.placement.acquire()
        if slot is None:
            if required:
                raise PlacementError(
                    f"placement policy exhausted: "
                    f"{self.placement.slots_total} slot(s) total, none "
                    "free — fewer replicas or a smaller TP degree")
            return None
        if not slot.holds_this_rank() and self._fw is None:
            self.placement.release(slot)
            raise _forward().no_world(slot, "a replica set")
        return slot

    def _with_slot(self, slot) -> dict:
        cfg = dict(self._engine_cfg)
        if slot is not None:
            cfg["placement"] = slot
        return cfg

    def _build(self, slot, name: str, idx: Optional[int] = None):
        """An engine of replica ``name`` on ``slot``: of module ``idx``
        (an initial replica), or of the scale-up module (None)."""
        module = (self._modules[idx] if idx is not None
                  and self._modules is not None else self._scale_module)
        return self._engine_cls(module, name=name, with_batcher=False,
                                **self._with_slot(slot))

    def _engine_for(self, name: str, slot, idx: Optional[int] = None):
        """This rank's engine of replica ``name`` on ``slot`` (``idx``:
        see :meth:`_build`; None for a scale-up, which the driver alone
        makes).  In a forwarded set: on the driver, a
        :class:`_ForwardedEngine` for a slot other ranks hold (their
        engines built now, or by their executors for a scale-up); on a
        follower, None."""
        link = self._fw.link(slot) if self._fw is not None else None
        if link is None:
            return None if self._follower else self._build(slot, name, idx)
        self._fw.add(link, name, idx, initial=idx is not None)
        return _ForwardedEngine(name, link) if self._fw.driver else None

    # ---------------------------------------------------------------- #
    # dispatch                                                         #
    # ---------------------------------------------------------------- #
    def _dispatch_batch(self, x_padded: np.ndarray):
        """Batcher callback: run on the best replica, re-dispatching a
        failed batch to another (bounded) so an accepted request only
        fails when the whole set is down.  The batcher binds the
        batch's request ids to this thread before calling, so the
        failover hops land in every affected request's span tree."""
        from bigdl_tpu_torch.obs import flight
        from bigdl_tpu_torch.obs.tracer import (get_request_context,
                                                get_tracer)
        tracer = get_tracer()
        rids = list(get_request_context()) if tracer.enabled else []
        tried: set = set()
        redispatches = 0
        last: Optional[BaseException] = None
        while True:
            rep = self._pick(tried)
            if rep is None:
                self._registry.counter("resilience/backend_lost").add(1)
                flight.get_flight_recorder().record(
                    "backend_lost",
                    {"reason": "no_replica_available",
                     "tried": sorted(tried),
                     "redispatches": redispatches,
                     "error": str(last)},
                    key="replicaset")
                raise BackendLostError(
                    f"no serving replica available ({len(tried)} tried, "
                    f"{redispatches} re-dispatches): {last}") from last
            try:
                span_args = {"replica": rep.name, "attempt": redispatches}
                if rids:
                    span_args["request_ids"] = rids
                with tracer.span("resilience/dispatch", cat="resilience",
                                 **span_args):
                    y = rep.engine._run_batch(x_padded)
            except Exception as e:  # noqa: BLE001 — classified below
                self._record_failure(rep, e)
                if classify_error(e) == "fatal":
                    # a model/shape bug fails identically on every
                    # replica: surface it, don't open every circuit
                    raise
                last = e
                tried.add(rep.name)
                redispatches += 1
                if redispatches > self.max_redispatch:
                    self._registry.counter("resilience/backend_lost").add(1)
                    flight.get_flight_recorder().record(
                        "backend_lost",
                        {"reason": "redispatch_bound",
                         "tried": sorted(tried),
                         "redispatches": redispatches,
                         "error": str(e)},
                        key="replicaset")
                    raise BackendLostError(
                        f"batch failed on {redispatches} replicas "
                        f"(re-dispatch bound reached): {e}") from e
                self._registry.counter("resilience/failovers").add(1)
                tracer.instant(
                    "resilience/failover", cat="resilience",
                    failed_replica=rep.name, redispatch=redispatches,
                    error=f"{type(e).__name__}: {e}",
                    **({"request_ids": rids} if rids else {}))
                log.warning("replica %s failed a batch, re-dispatching "
                            "(%d/%d): %s", rep.name, redispatches,
                            self.max_redispatch, e)
                continue
            self._record_success(rep)
            return y

    # ---------------------------------------------------------------- #
    # public API (mirrors ServingEngine)                               #
    # ---------------------------------------------------------------- #
    def _coerce(self, x, batched: bool) -> np.ndarray:
        return self._replicas[0].engine._coerce(x, batched)

    def warmup(self, input_shape: Optional[tuple] = None) -> int:
        """Pre-compile every bucket on every replica; returns the total
        number of executables compiled (in a forwarded set the driver's
        call warms every slot: on any other rank, 0)."""
        return sum(r.engine.warmup(input_shape) for r in self._replicas
                   if r.state != DRAINING)

    def scale_to(self, n: int, *, drain_timeout_s: float = 10.0) -> int:
        """SLO-controller actuator: grow or shrink the live replica
        count without touching the queue.

        Growing builds fresh batcher-less engines (the same module —
        heterogeneous sets grow with their first member's) and warms
        them when an input shape is known, so the next dispatch pays no
        compile.  Shrinking marks the newest replicas DRAINING (the
        picker skips them immediately), waits for their in-flight
        batches, then closes their engines — an accepted request is
        never dropped by a scale-down.  Returns the live count."""
        n = int(n)
        if n < 1:
            raise ValueError("scale_to needs n >= 1")
        self._driver_only("scale_to")
        with self._lock:
            live = [r for r in self._replicas if r.state != DRAINING]
        if n > len(live):
            warm_shape = live[0].engine.input_shape if live else None
            added = 0
            for _ in range(n - len(live)):
                slot = None
                if self.placement is not None:
                    slot = self._acquire_slot(required=False)
                    if slot is None:
                        # full device set: grow as far as the slots go
                        # rather than stacking replicas on shared devices
                        log.warning(
                            "scale_to(%d): placement headroom exhausted "
                            "after +%d replica(s)", n, added)
                        break
                name = f"r{self._next_idx}"
                self._next_idx += 1
                try:
                    engine = self._engine_for(name, slot)
                except BaseException:
                    if slot is not None:
                        self.placement.release(slot)
                    raise
                if warm_shape is not None:
                    engine.warmup(warm_shape)
                with self._lock:
                    self._replicas.append(_Replica(name, engine, slot=slot))
                added += 1
                log.info("replica %s: added by scale_to(%d)", name, n)
            self._registry.counter("resilience/scale_ups").add(added)
        elif n < len(live):
            victims = live[n:]  # newest first out: r0 keeps seniority
            with self._lock:
                for r in victims:
                    r.state = DRAINING
            deadline = time.monotonic() + float(drain_timeout_s)
            for r in victims:
                while r.inflight > 0 and time.monotonic() < deadline:
                    time.sleep(0.005)
                r.engine.close()
                if r.slot is not None:
                    self.placement.release(r.slot)
                    r.slot = None
                log.info("replica %s: drained and closed by scale_to(%d)",
                         r.name, n)
            with self._lock:
                self._replicas = [r for r in self._replicas
                                  if r not in victims]
            self._registry.counter("resilience/scale_downs") \
                .add(len(victims))
        self._publish_open_circuits()
        self._publish_replica_count()
        with self._lock:
            return sum(1 for r in self._replicas if r.state != DRAINING)

    def try_scale_up(self, max_replicas: Optional[int] = None) -> bool:
        """The SLO controller's device-aware scale_up hook: add ONE
        replica if the placement policy has a free slot (always, when
        unplaced) and the set is under ``max_replicas``; returns whether
        capacity was actually added (False makes the controller's ladder
        fall through to admission tightening instead of
        oversubscribing)."""
        self._driver_only("try_scale_up")
        with self._lock:
            live = sum(1 for r in self._replicas if r.state != DRAINING)
        if max_replicas is not None and live >= int(max_replicas):
            return False
        if self.placement is not None and self.placement.headroom() < 1:
            return False
        return self.scale_to(live + 1) > live

    def _driver_only(self, what: str) -> None:
        if self._follower:
            self._fw.require_driver(f"ReplicaSet.{what}")

    def submit(self, x, *, batched: bool = True) -> Future:
        self._driver_only("submit")
        if self._closed:
            from bigdl_tpu_torch.serving.errors import ServingClosed
            raise ServingClosed("replica set is closed")
        return self.batcher.submit(self._coerce(x, batched))

    def predict(self, x, *, timeout: Optional[float] = None) -> np.ndarray:
        return self.submit(x).result(timeout=timeout)

    def predict_one(self, x, *,
                    timeout: Optional[float] = None) -> np.ndarray:
        fut = self.submit(self._coerce(x, batched=False), batched=True)
        return fut.result(timeout=timeout)[0]

    def stats(self) -> dict:
        if self.batcher is None:
            # a forwarded set's rank other than the driver: its own slots
            return {"replicas": {}, "pending": 0,
                    "local": {sid: e.stats() for sid, e in
                              self._fw.engines.items()},
                    "placement": self.placement.stats()}
        with self._lock:
            replicas = {
                r.name: {"state": r.state, "inflight": r.inflight,
                         "dispatched": r.dispatched,
                         "failures": r.failures,
                         "consecutive_failures": r.consecutive_failures,
                         "placement": (r.slot.describe()
                                       if r.slot is not None else None)}
                for r in self._replicas}
        return {
            "replicas": replicas,
            "pending": self.batcher.pending(),
            "buckets": list(self.batcher.buckets),
            "placement": (self.placement.stats()
                          if self.placement is not None else None),
            "metrics": self.metrics.snapshot(
                self._replicas[0].engine.cache.stats()),
        }

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Graceful drain: stop intake, serve what is queued, then shut
        the replicas down.  A forwarded set's rank other than the driver
        returns once the driver's close has drained the set."""
        if self._closed:
            return
        self._closed = True
        if self._follower:
            self._fw.shutdown()
            for s in self._held:
                self.placement.release(s)
            self._held.clear()
            return
        self.batcher.close(timeout=timeout)
        with self._lock:
            for r in self._replicas:
                r.state = DRAINING
        for r in self._replicas:
            r.engine.close()
            if r.slot is not None:
                self.placement.release(r.slot)
                r.slot = None
        if self._fw is not None:
            self._fw.shutdown()
        self._publish_open_circuits()

    def __enter__(self) -> "ReplicaSet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
