"""LMReplicaSet: N LMServingEngine replicas of one model behind one
routed front (port of ``bigdl_tpu/serving/router/replicaset.py``).

Built on :class:`~bigdl_tpu_torch.resilience.replicaset.ReplicaSetCore`
(breakers, bounded re-dispatch), with a stream as the unit of dispatch:
each submit picks a replica once (sticky session, then the router's
affinity score, then least-loaded) and the request's whole life runs
there, so that replica's radix cache holds the session's prefix.

Failover is per stream and bit-exact: a relay thread forwards the inner
engine stream into the client's :class:`RoutedLMStream`; when the inner
stream dies with a re-routable error (transient, backend lost, or the
member engine closing), the relay submits the SAME prompt with the SAME
seed and temperature to another replica and skips the tokens it already
forwarded.  Deterministic prefill and the seeded key chain make the
replayed tokens identical.  An accepted request is lost only when every
replica is gone.

Hibernation composes: :meth:`LMReplicaSet.hibernate` swaps the stream
into its replica's host tier and pins the session there;
:meth:`LMReplicaSet.resume` prefers that replica.  If it died meanwhile,
its ``_fail_all`` already resolved the inner stream, the relay replayed
it elsewhere, and the session is repointed.

On one card the replicas are engines of one process sharing the model's
parameter tensors, each with its own arenas, graph pool and worker
stream.  Flight bundles carry the set's ``stats()`` (circuit states,
router, sessions) as ``lm_replicaset``, beside each engine's own.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

import numpy as np

from bigdl_tpu_torch.obs import get_tracer, mint_request_id
from bigdl_tpu_torch.resilience.errors import (BackendLostError,
                                               ServingDeadlineExceeded,
                                               classify_error)
from bigdl_tpu_torch.resilience.replicaset import (DRAINING, HedgePolicy,
                                                   ReplicaSetCore, _Replica)
from bigdl_tpu_torch.serving.errors import ServingClosed, ServingOverloaded
from bigdl_tpu_torch.serving.kvcache.radix import prefix_signatures
from bigdl_tpu_torch.serving.lm_engine import (LMMetrics, LMServingEngine,
                                               LMStream)
from bigdl_tpu_torch.serving.router.router import RadixRouter
from bigdl_tpu_torch.serving.router.sessions import SessionTable
from bigdl_tpu_torch.serving.router.summary import RadixSummary

log = logging.getLogger("bigdl_tpu_torch.serving")
_tracer = get_tracer()


class RoutedLMStream(LMStream):
    """Client handle for a routed request: an :class:`LMStream` whose
    tokens arrive via the relay, surviving replica failover underneath.
    ``replica_name`` / ``inner`` track the CURRENT placement (they move
    on failover); ``re_dispatches`` counts the hops; ``hedged`` marks a
    request that fired a speculative duplicate dispatch."""

    def __init__(self, prompt_1b, max_new, request_id=None,
                 session_id=None, deadline_s=None):
        super().__init__(prompt_1b, max_new, request_id=request_id,
                         deadline_s=deadline_s)
        self.session_id = session_id
        self.replica_name: Optional[str] = None
        self.inner: Optional[LMStream] = None
        self.re_dispatches = 0
        self.hedged = False
        self._hedge_inner: Optional[LMStream] = None

    def cancel(self) -> bool:
        """Cooperative cancel, propagated through the routed front:
        the CURRENT inner engine stream (and a hedge duplicate, if one
        is in flight) each get the cancel, so every replica touching
        this request recycles its slot at its next scheduler round."""
        live = super().cancel()
        for s in (self.inner, self._hedge_inner):
            if s is not None:
                try:
                    s.cancel()
                except Exception:
                    pass
        return live


class LMReplicaSet(ReplicaSetCore):
    """Serve one built ``TransformerLM`` from ``n_replicas`` engines
    with cache-aware routing and stream-granular failover.

    Args:
        model: a ``TransformerLM`` with params; every replica shares
            its parameter tensors, so any replica's output for a given
            (prompt, seed, temperature) is the single engine's: the
            bit-exact replay failover depends on this.
        n_replicas: member count (default 2).
        router: a :class:`RadixRouter` for prefix-affinity dispatch, or
            None for the radix-blind least-loaded baseline.  Each member's RadixCache publishes a
            :class:`RadixSummary` into the router.
        sessions: a :class:`SessionTable` (default: private table) —
            session stickiness runs ahead of affinity scoring.
        kvtier_factory: ``factory(replica_name) -> HostBlockStore | None``
            building one PRIVATE host tier per replica (a shared store
            would alias ``("session", rid)`` keys across members).
        failure_threshold / cooldown_s / max_redispatch / clock: the
            :class:`ReplicaSetCore` breaker knobs (max_redispatch
            defaults to ``n_replicas - 1``: try every other member).
        hedge: a :class:`HedgePolicy` enabling speculative re-dispatch
            (Spark's speculative execution reborn at stream granularity):
            a hedge-eligible request whose wait-to-first-token exceeds
            the policy's windowed tail trigger is duplicated onto the
            next-best replica; the first stream to finish wins and the
            loser is cooperatively cancelled.  None (default) disables.
        **engine_kwargs: forwarded to every :class:`LMServingEngine`
            (slots, cache_len, block_len, num_blocks, device, ...).
    """

    def __init__(self, model, n_replicas: int = 2, *,
                 router: Optional[RadixRouter] = None,
                 sessions: Optional[SessionTable] = None,
                 kvtier_factory: Optional[Callable] = None,
                 failure_threshold: int = 3,
                 cooldown_s: float = 5.0,
                 max_redispatch: Optional[int] = None,
                 clock=time.monotonic,
                 hedge: Optional[HedgePolicy] = None,
                 name: str = "lmset",
                 **engine_kwargs):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self._init_core(
            failure_threshold=failure_threshold, cooldown_s=cooldown_s,
            max_redispatch=(int(max_redispatch) if max_redispatch
                            is not None else max(1, n_replicas - 1)),
            clock=clock, dispatch_policy=self._policy,
            hedge_policy=hedge)
        self.name = name
        self.router = router
        self.sessions = sessions if sessions is not None else SessionTable()
        self.hibernations = 0
        self.resumes = 0
        self.resume_re_routes = 0
        self._closed = False
        reg = self._registry
        self._c_dispatches = reg.counter("serving/router/dispatches")
        self._c_sticky = reg.counter("serving/router/sticky_hits")
        self._c_re_routes = reg.counter("serving/router/re_routes")
        # one shared LMMetrics: set-wide TTFT/ITL histograms (the SLO
        # view), same pattern as the disagg phase pools
        slots = int(engine_kwargs.get("slots", 8))
        self.metrics = LMMetrics(slots * n_replicas)
        try:
            for i in range(n_replicas):
                ename = f"{name}-r{i}"
                tier = kvtier_factory(ename) if kvtier_factory else None
                eng = LMServingEngine(model, name=ename,
                                      metrics=self.metrics, kvtier=tier,
                                      **engine_kwargs)
                self._replicas.append(_Replica(ename, eng))
                if self.router is not None and eng.radix is not None:
                    summary = RadixSummary(ename)
                    eng.attach_radix_summary(summary)
                    self.router.register(ename, summary)
        except BaseException:
            for r in self._replicas:
                r.engine.close()
            raise
        self.block_len = self._replicas[0].engine.block_len
        self.max_new_tokens = self._replicas[0].engine.max_new_tokens
        self._publish_open_circuits()
        self._publish_replica_count()
        try:
            import weakref

            from bigdl_tpu_torch.obs import flight
            wself = weakref.ref(self)

            def _flight_state():
                rs = wself()
                return rs.stats() if rs is not None else None

            flight.register_state("lm_replicaset", _flight_state)
        except Exception:
            log.exception("flight-recorder registration failed")

    # -- replica selection ----------------------------------------------- #
    def _policy(self, healthy, ctx):
        """ReplicaSetCore dispatch policy: sticky session first, then
        the router's affinity score; None falls back to least-loaded.
        Runs under the set lock — lookups only, no engine calls."""
        sticky = ctx.get("sticky")
        if sticky is not None:
            for r in healthy:
                if r.name == sticky:
                    ctx["picked_sticky"] = True
                    return r
            # the preferred replica is excluded/unhealthy/gone: the
            # request re-routes (and re-prefills) elsewhere
            ctx["sticky_lost"] = True
        if self.router is not None:
            return self.router.pick(healthy, ctx)
        return None

    def _by_name(self, name: str) -> Optional[_Replica]:
        with self._lock:
            for r in self._replicas:
                if r.name == name:
                    return r
        return None

    # -- dispatch --------------------------------------------------------- #
    def _dispatch(self, prompt, kw: dict, ctx: dict, tried: set):
        """Pick a replica and enqueue the prompt there, walking the
        candidates on replica-local failures.  Returns ``(rep, inner)``
        with the pick's inflight slot held (released by the relay's
        success/failure record).  Raises the last typed overload when
        every candidate shed, BackendLostError when none was left."""
        last: Optional[BaseException] = None
        while True:
            ctx.pop("picked_sticky", None)
            ctx.pop("sticky_lost", None)
            rep = self._pick(tried, ctx)
            if rep is None:
                if isinstance(last, ServingOverloaded):
                    raise last   # saturated, not gone: typed backpressure
                self._registry.counter("resilience/backend_lost").add(1)
                raise BackendLostError(
                    f"no LM replica available ({len(tried)} tried): "
                    f"{last}") from last
            try:
                inner = rep.engine.submit(prompt, **kw)
            except ServingDeadlineExceeded:
                # a blown deadline is a property of the REQUEST, not of
                # the replica: walking more candidates cannot un-expire
                # it, and charging the breaker would punish a healthy
                # member for correct admission control.  Release the
                # inflight slot as a clean interaction and surface the
                # typed shed to the caller.
                self._record_success(rep)
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                self._record_failure(rep, e)
                # a closed MEMBER is a dead replica, not a dead set
                if (classify_error(e) == "fatal"
                        and not isinstance(e, ServingClosed)):
                    raise
                tried.add(rep.name)
                last = e
                continue
            if ctx.pop("picked_sticky", False):
                self.sessions.note_sticky_hit()
                self._c_sticky.add(1)
            elif ctx.pop("sticky_lost", False):
                self.sessions.note_re_route()
                self._c_re_routes.add(1)
            sid = ctx.get("session_id")
            if sid is not None:
                self.sessions.record(sid, rep.name)
            self._c_dispatches.add(1)
            return rep, inner

    def submit(self, prompt_ids, *, session_id: Optional[str] = None,
               max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               eos_id: Optional[int] = None,
               rng=None, deadline_s: Optional[float] = None,
               hedgeable: bool = False) -> RoutedLMStream:
        """Route one prompt; returns a stream that survives the death
        of any replica serving it.  Pass ``rng`` as an int seed when
        ``temperature > 0`` — failover re-submits with the same seed,
        which is what keeps the replayed tokens identical.

        ``deadline_s`` is the request's end-to-end wall-clock budget,
        minted HERE: failover re-dispatch forwards the REMAINING budget
        (never a reset one), and each member engine sheds/truncates
        against the same absolute instant.  ``hedgeable=True`` marks a
        request the client consumes whole (not token-by-token), making
        it eligible for the set's :class:`HedgePolicy` speculative
        duplicate — duplicated decode is invisible only when nobody is
        watching the stream race."""
        if self._closed:
            raise ServingClosed("LMReplicaSet is closed")
        prompt = np.asarray(prompt_ids).reshape(-1).astype(np.int32)
        rid = mint_request_id()
        ctx = {
            "rid": rid,
            "session_id": session_id,
            "sticky": self.sessions.lookup(session_id),
            "prompt_sigs": prefix_signatures(prompt - 1, self.block_len),
            "hedgeable": bool(hedgeable),
        }
        kw = dict(max_new_tokens=max_new_tokens, temperature=temperature,
                  eos_id=eos_id, rng=rng, deadline_s=deadline_s)
        tried: set = set()
        if self.hedge_policy is not None:
            self.hedge_policy.note_dispatch()
        rep, inner = self._dispatch(prompt, kw, ctx, tried)
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.max_new_tokens)
        out = RoutedLMStream(prompt, max_new, request_id=rid,
                             session_id=session_id, deadline_s=deadline_s)
        out.replica_name, out.inner = rep.name, inner
        t = threading.Thread(
            target=self._relay, args=(out, rep, inner, prompt, kw, ctx),
            name=f"{self.name}-relay-{rid}", daemon=True)
        t.start()
        return out

    def _relay(self, out: RoutedLMStream, rep, inner, prompt, kw, ctx):
        """Forward the inner stream into the routed one; on a
        re-routable death, re-submit the same request elsewhere and
        skip what the client already saw (bit-exact replay).  The relay
        is also where the request's lifecycle rides the hops: a hedge
        window opens before the first token, failover forwards the
        REMAINING deadline budget, and a client cancel noticed here
        short-circuits re-dispatch entirely."""
        tried: set = set()
        while True:
            if (self.hedge_policy is not None and ctx.get("hedgeable")
                    and not out.hedged and len(out.generated) == 0):
                picked = self._maybe_hedge(out, rep, inner, prompt, kw,
                                           ctx, tried)
                if picked is not None:
                    rep, inner = picked
                    out.replica_name, out.inner = rep.name, inner
            try:
                skip = len(out.generated)
                i = 0
                for tok in inner.tokens():
                    i += 1
                    if i > skip:
                        out._emit(tok)
                self._record_success(rep)
                if self.hedge_policy is not None and not out.hedged:
                    ttft = inner.ttft_s
                    if ttft is not None:
                        self.hedge_policy.observe(ttft)
                tr = getattr(inner, "truncation", None)
                if tr is not None and out.truncation is None:
                    # the member truncated (deadline/cancel honored
                    # mid-stream): the routed front finishes the same
                    # way — cleanly, with the typed marker
                    out._finish_truncated(tr.reason)
                else:
                    out._finish()
                return
            except BaseException as e:  # noqa: BLE001 — classified below
                if isinstance(e, ServingDeadlineExceeded):
                    # the member shed a blown deadline: correct
                    # admission control, not a replica fault — don't
                    # charge the breaker, don't walk other replicas
                    self._record_success(rep)
                    if len(out.generated):
                        out._finish_truncated("deadline")
                    else:
                        out._finish(e)
                    return
                self._record_failure(rep, e)
                if (classify_error(e) == "fatal"
                        and not isinstance(e, ServingClosed)):
                    out._finish(e)
                    return
                if out.cancel_requested:
                    # the client already walked away: re-dispatching
                    # would burn decode on an unwatched stream
                    out._finish_truncated("cancelled")
                    return
                rem = out.remaining_s()
                if isinstance(e, ServingDeadlineExceeded) or (
                        rem is not None and rem <= 0.0):
                    # the budget died with the replica: no re-dispatch
                    if len(out.generated):
                        out._finish_truncated("deadline")
                    else:
                        out._finish(e if isinstance(
                            e, ServingDeadlineExceeded)
                            else ServingDeadlineExceeded(
                                f"request {out.request_id} deadline "
                                f"expired during failover"))
                    return
                tried.add(rep.name)
                out.re_dispatches += 1
                if out.re_dispatches > self.max_redispatch:
                    self._registry.counter("resilience/backend_lost").add(1)
                    out._finish(BackendLostError(
                        f"stream failed on {out.re_dispatches} replicas "
                        f"(re-dispatch bound reached): {e}"))
                    return
                self._registry.counter("resilience/failovers").add(1)
                self._c_re_routes.add(1)
                self.sessions.note_re_route()
                if _tracer.sampled(out.request_id):
                    _tracer.instant(
                        "router/failover", cat="serve",
                        request_id=out.request_id, failed_replica=rep.name,
                        re_dispatch=out.re_dispatches,
                        replayed_tokens=len(out.generated),
                        error=f"{type(e).__name__}: {e}")
                log.warning("%s: stream %s lost replica %s, re-routing "
                            "(%d/%d, replaying %d tokens): %s", self.name,
                            out.request_id, rep.name, out.re_dispatches,
                            self.max_redispatch, len(out.generated), e)
                ctx = dict(ctx)
                ctx["sticky"] = None   # the sticky replica just failed
                if rem is not None:
                    # the re-dispatch inherits what is LEFT of the
                    # budget, never a fresh one — a hop is not a reason
                    # to promise the client more time
                    kw = dict(kw)
                    kw["deadline_s"] = rem
                try:
                    rep, inner = self._dispatch(prompt, kw, ctx, tried)
                except BaseException as e2:  # noqa: BLE001
                    out._finish(e2)
                    return
                out.replica_name, out.inner = rep.name, inner

    def _maybe_hedge(self, out: RoutedLMStream, rep, inner, prompt, kw,
                     ctx, tried: set):
        """Hedge window: wait for the primary's first token up to the
        policy's tail trigger; past it (and within the hedge budget),
        duplicate the request onto the next-best replica and race the
        two streams.  Returns the winning ``(rep, inner)`` pair for the
        relay to forward, or None to continue with the primary.  Both
        replicas compute identical tokens (same prompt, same seed), so
        whichever finishes first IS the answer — the loser is
        cooperatively cancelled and frees its slot within one scheduler
        round."""
        pol = self.hedge_policy
        trig = pol.trigger_s()
        if trig is None:
            return None   # not enough wait evidence to aim a hedge yet
        with inner._cond:
            inner._cond.wait_for(
                lambda: inner._tokens or inner._done,
                timeout=max(0.0, (out.submitted_at + trig)
                            - time.perf_counter()))
            started = bool(inner._tokens) or inner._done
        if started:
            return None   # primary is producing (or already resolved)
        waited = time.perf_counter() - out.submitted_at
        if not pol.should_hedge(waited):
            return None
        hctx = dict(ctx)
        hctx["sticky"] = None   # the point is a DIFFERENT replica
        hkw = dict(kw)
        rem = out.remaining_s()
        if rem is not None:
            if rem <= 0.0:
                return None   # the deadline sweep owns this request now
            hkw["deadline_s"] = rem
        try:
            hrep, hinner = self._dispatch(prompt, hkw, hctx,
                                          set(tried) | {rep.name})
        except BaseException:  # noqa: BLE001 — no second seat, no hedge
            return None
        pol.note_fired()
        out.hedged = True
        out._hedge_inner = hinner
        if _tracer.sampled(out.request_id):
            _tracer.instant(
                "router/hedge_fired", cat="serve",
                request_id=out.request_id, primary=rep.name,
                hedge=hrep.name, waited_s=round(waited, 6),
                trigger_s=round(trig, 6))
        log.info("%s: request %s hedged %s -> %s (waited %.3fs, "
                 "trigger %.3fs)", self.name, out.request_id, rep.name,
                 hrep.name, waited, trig)
        # a side stream's inflight/breaker accounting settles when its
        # cancel is honored (next scheduler round on its engine) — a
        # tiny waiter keeps the relay free to forward the winner NOW
        def _settle(side_stream, side_rep):
            def _run():
                with side_stream._cond:
                    side_stream._cond.wait_for(
                        lambda: side_stream._done, timeout=30.0)
                if side_stream._error is not None:
                    self._record_failure(side_rep, side_stream._error)
                else:
                    self._record_success(side_rep)
            threading.Thread(target=_run, daemon=True,
                             name=f"{self.name}-hedge-settle-"
                                  f"{out.request_id}").start()

        # first completion WITHOUT an error wins; a mid-hedge replica
        # kill resolves its stream with an error, which simply forfeits
        # the race to the survivor.  Both dead -> hand the primary back
        # and let the relay's failover path re-dispatch (both names are
        # in ``tried``).
        while True:
            p_done, h_done = inner.done(), hinner.done()
            if p_done and inner._error is None:
                winner, wrep = inner, rep
                loser, lrep, hedge_won = hinner, hrep, False
                break
            if h_done and hinner._error is None:
                winner, wrep = hinner, hrep
                loser, lrep, hedge_won = inner, rep, True
                break
            if p_done and h_done:
                tried.add(hrep.name)
                self._record_failure(hrep, hinner._error)
                pol.note_outcome(False)
                out._hedge_inner = None
                return None
            if out.cancel_requested:
                # client cancelled mid-race: both inners already got
                # the cancel via RoutedLMStream.cancel; let the relay's
                # normal path observe the primary's truncation, and
                # settle the hedge seat when its cancel lands
                pol.note_outcome(False)
                out._hedge_inner = None
                _settle(hinner, hrep)
                return None
            time.sleep(0.002)
        loser.cancel()
        pol.note_outcome(hedge_won)
        out._hedge_inner = None
        if _tracer.sampled(out.request_id):
            _tracer.instant(
                "router/hedge_resolved", cat="serve",
                request_id=out.request_id, winner=wrep.name,
                hedge_won=hedge_won)
        _settle(loser, lrep)
        return wrep, winner

    # -- hibernation (composes with kvtier) ------------------------------- #
    def hibernate(self, stream: RoutedLMStream, *,
                  timeout: Optional[float] = 30.0) -> bool:
        """Swap the stream out on ITS replica (the chain demotes into
        that replica's host tier) and pin the session there — the
        resume fast path needs the tier entry's owner."""
        rep = self._by_name(stream.replica_name)
        if rep is None:
            return False
        ok = rep.engine.hibernate(stream.inner, timeout=timeout)
        if ok:
            self.hibernations += 1
            if stream.session_id is not None:
                self.sessions.mark_hibernated(stream.session_id, rep.name)
        return ok

    def resume(self, stream: RoutedLMStream) -> bool:
        """Wake a hibernated stream.  Fast path: its replica is alive
        and promotes the chain back from its tier.  Degraded path: the
        replica died — its ``_fail_all`` resolved the inner stream, the
        relay already re-prefilled and replayed on a survivor, and this
        just repoints the session (returns True: the stream IS live).
        False only when the stream was never hibernated."""
        rep = self._by_name(stream.replica_name)
        if rep is not None and rep.state != DRAINING:
            try:
                if rep.engine.resume(stream.inner):
                    self.resumes += 1
                    return True
                if stream.re_dispatches == 0:
                    return False
                # not hibernated HERE because the holder died and the
                # relay already moved the stream: degraded path below
            except ServingClosed:
                pass
        self.resume_re_routes += 1
        self.sessions.note_re_route()
        self._c_re_routes.add(1)
        return True

    # -- chaos ------------------------------------------------------------ #
    def kill_replica(self, name: str,
                     error: Optional[BaseException] = None) -> None:
        """Abrupt replica death (chaos hook): the member stops serving
        NOW and every stream it held — seated, queued, or hibernated —
        resolves with a backend-lost error, which is exactly what wakes
        each relay into its re-route+replay path.  The replica never
        returns (DRAINING)."""
        rep = self._by_name(name)
        if rep is None:
            raise KeyError(f"no replica named {name!r}")
        with self._lock:
            rep.state = DRAINING
        self._publish_open_circuits()
        self._publish_replica_count()
        if self.router is not None:
            self.router.unregister(name)
        err = error if error is not None else BackendLostError(
            f"chaos: replica {name} killed")
        eng = rep.engine
        with eng._cv:
            eng._closing = True
            eng._abort = True
            eng._cv.notify_all()
        eng._worker.join(5.0)
        eng._fail_all(err)
        _tracer.instant("router/replica_killed", cat="serve", replica=name)
        log.warning("%s: replica %s killed (chaos)", self.name, name)

    # -- introspection / lifecycle ---------------------------------------- #
    def prefix_cache_stats(self) -> dict:
        """Set-wide radix accounting: the SUM over members (per-replica
        hit rates reward imbalance; the set's rate is what routing
        improves)."""
        lookups = hits = saved = 0
        with self._lock:
            engines = [r.engine for r in self._replicas]
        for eng in engines:
            if eng.radix is None:
                continue
            s = eng.radix.stats()
            lookups += s["lookups"]
            hits += s["hits"]
            saved += s["prefill_tokens_saved"]
        return {"lookups": lookups, "hits": hits,
                "hit_rate": (hits / lookups) if lookups else None,
                "prefill_tokens_saved": saved}

    def warmup(self) -> int:
        with self._lock:
            engines = [r.engine for r in self._replicas
                       if r.state != DRAINING]
        return sum(e.warmup() for e in engines)

    def warmup_prefix(self, suffix_lens=None, prefix_blocks=None) -> int:
        """Make every member's prefix-suffix prefill entries (see
        :meth:`LMServingEngine.warmup_prefix`): affinity routing exists
        to hit that path, so warm it on all replicas before traffic."""
        with self._lock:
            engines = [r.engine for r in self._replicas
                       if r.state != DRAINING]
        return sum(e.warmup_prefix(suffix_lens, prefix_blocks)
                   for e in engines)

    def lifecycle_stats(self) -> dict:
        """Set-wide lifecycle accounting: the SUM of every member's
        expired, cancelled and wasted counters."""
        with self._lock:
            engines = [r.engine for r in self._replicas]
        total: dict = {}
        for eng in engines:
            for k, v in eng.lifecycle_stats().items():
                total[k] = total.get(k, 0) + v
        return total

    def stats(self) -> dict:
        with self._lock:
            replicas = {
                r.name: {"state": r.state, "inflight": r.inflight,
                         "dispatched": r.dispatched,
                         "failures": r.failures,
                         "consecutive_failures": r.consecutive_failures}
                for r in self._replicas}
        return {
            "name": self.name,
            "replicas": replicas,
            "router": (self.router.stats()
                       if self.router is not None else None),
            "sessions": self.sessions.stats(),
            "prefix_cache": self.prefix_cache_stats(),
            "hibernations": self.hibernations,
            "resumes": self.resumes,
            "resume_re_routes": self.resume_re_routes,
            "lifecycle": self.lifecycle_stats(),
            "hedge": (self.hedge_policy.stats()
                      if self.hedge_policy is not None else None),
            "metrics": self.metrics.snapshot(),
        }

    def close(self, timeout: Optional[float] = 30.0) -> None:
        self._closed = True
        with self._lock:
            reps = list(self._replicas)
            for r in reps:
                r.state = DRAINING
        for r in reps:
            if self.router is not None:
                self.router.unregister(r.name)
            try:
                r.engine.close(timeout)
            except Exception:
                log.exception("closing replica %s failed", r.name)
        self._publish_open_circuits()

    def __enter__(self) -> "LMReplicaSet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
