"""DisaggCoordinator: phase replicas with KV-chain migration between
them (port of ``bigdl_tpu/serving/disagg/coordinator.py``).

Prefill is one large compute-bound pass a request, decode a
memory-bound step a token; an engine that interleaves them stalls every
decoding stream behind each long prompt.  Disaggregation (DistServe,
Splitwise) runs the two phases on separate replicas, so TTFT is the
prefill pool's concern and the inter-token gap the decode pool's.

- **prefill replicas** are :class:`LMServingEngine` s built with
  ``migrate=<the coordinator's callback>``: they prefill, emit the
  first token, then hand the request off instead of seating it.  They
  never capture or run the decode step.
- **decode replicas** are plain engines; they take migrated requests
  through :meth:`LMServingEngine.adopt` and decode over chains they
  adopted.
- **the hop**: :meth:`BlockPool.export_chain` on the prefill worker
  (gather, then a synchronous copy to the host, on that worker's
  stream, after its last insert), then :meth:`BlockPool.adopt_chain`
  on the decode worker (pinned staging, the copies and ``index_copy_``
  on that worker's stream, before its next replay).  Before exporting,
  the coordinator matches the DECODE replica's radix against the prompt
  (the trie is lock-guarded): blocks it already holds do not travel.
- **faults**: the export runs under ``with_backoff`` around the
  ``serving.migrate`` fault site.  A transient retries; a lost backend
  drops the payload and the decode replica re-prefills the prompt
  (deterministic, so the rows are bitwise the same; the first token is
  never picked again), counted in ``lost_payloads`` and the decode
  engines' ``re_prefills``.
- **scaling**: :meth:`try_scale_up` adds a replica to one phase, up to
  ``max_replicas_per_phase``; :meth:`slo_controllers` wires TTFT to the
  prefill pool and the decode gap to the decode pool, over one shared
  :class:`LMMetrics` per phase (``serving/lm/prefill/*``,
  ``serving/lm/decode/*``).

Every unplaced replica shares the model's parameter tensors (read-only;
each engine's CUDA graphs captured their addresses).  Under a
``PlacementPolicy`` each replica acquires a slot tagged with its phase,
and its engine stages the params onto it: a prefill replica on one card
and a decode replica on another need no copy path of their own, since
the hop already goes through host memory.

A policy with slots on other ranks of a process world makes the pair
*forwarded* (``serving.placement.forward``): every rank builds the
coordinator with the same arguments and closes it; world rank 0, the
driver, takes every prompt and carries it, and every hop, to the slots'
ranks.  A hop keeps the reference's accounting: the decode slot's lead
peeks its radix and answers the matched length; the prefill slot's lead
exports only the unmatched tail (under ``with_backoff`` at the
``serving.migrate`` fault site); the payload travels through the driver
to every rank of the decode slot, which matches its radix in the round
that seats the adoption; a lost payload re-prefills there.  The driver
counts ``migrations``, ``migrated_blocks``, ``migrated_bytes`` and
``lost_payloads``, and fetches the remote engines' ``stats()``.  The
phase metrics of an engine on other ranks stay on those ranks.
"""
from __future__ import annotations

import functools
import itertools
import logging
import queue
import threading
from typing import Dict, List, Optional

import numpy as np

from bigdl_tpu_torch.obs import get_tracer
from bigdl_tpu_torch.resilience.errors import BackendLostError
from bigdl_tpu_torch.resilience.faults import fault_point
from bigdl_tpu_torch.resilience.retry import with_backoff
from bigdl_tpu_torch.serving.errors import ServingClosed
from bigdl_tpu_torch.serving.lm_engine import (KVHandoff, LMMetrics,
                                               LMServingEngine, LMStream)
from bigdl_tpu_torch.serving.placement import forward

_tracer = get_tracer()
log = logging.getLogger("bigdl_tpu_torch.serving")


class DisaggCoordinator:
    """Run prefill and decode on separate replica pools of one model.

    Args:
        model: a ``TransformerLM`` with params, shared by every replica.
        prefill_replicas / decode_replicas: initial pool sizes.
        placement: optional
            :class:`~bigdl_tpu_torch.serving.placement.PlacementPolicy`;
            each replica acquires its own slot (``acquire(phase=...)``,
            so the policy reports per-phase occupancy), and a full
            device set refuses a replica ("no free placement slot")
            rather than stacking it on a held slot.  Slots on other
            ranks of a process world make the pair forwarded (see the
            module docstring); without a world such a slot raises
            ``PlacementError``.  None: every replica on the model's
            device.
        max_replicas_per_phase: the scale-up ceiling of each phase (the
            placement policy's headroom bounds it too).
        migrate_retries / migrate_base_delay_s: ``with_backoff``'s
            parameters for the export at the ``serving.migrate`` site.
        name: prefix of the replica names (``<name>-prefill0``, ...).
        spec: speculative decoding for the DECODE replicas only.
        **engine_kwargs: forwarded to every :class:`LMServingEngine`
            (slots, cache_len, block_len, device, ...).
    """

    def __init__(self, model, *,
                 prefill_replicas: int = 1,
                 decode_replicas: int = 1,
                 placement=None,
                 max_replicas_per_phase: int = 4,
                 migrate_retries: int = 2,
                 migrate_base_delay_s: float = 0.05,
                 name: str = "disagg",
                 spec=None,
                 **engine_kwargs):
        if prefill_replicas < 1 or decode_replicas < 1:
            raise ValueError("each phase needs at least one replica")
        self.model = model
        self.name = name
        self.placement = placement
        self.max_replicas_per_phase = int(max_replicas_per_phase)
        self.migrate_retries = int(migrate_retries)
        self.migrate_base_delay_s = float(migrate_base_delay_s)
        self._spec = spec
        self._kw = dict(engine_kwargs)
        slots = int(self._kw.get("slots", 8))
        self._prefill_metrics = LMMetrics(slots * prefill_replicas)
        self._decode_metrics = LMMetrics(slots * decode_replicas)
        self._lock = threading.Lock()
        # held across a scale-up's build (which may wait on other ranks)
        # and by close, never with _lock held
        self._scale_lock = threading.Lock()
        self._slices: Dict[str, object] = {}   # engine name -> MeshSlice
        self._rr = 0                           # round-robin submit cursor
        self.migrations = 0
        self.migrated_blocks = 0
        self.migrated_bytes = 0                # wire bytes, k and v
        self.lost_payloads = 0
        self._closing = False
        # forwarded (see the module docstring): this rank's share of the
        # world; the driver's requests carried to other ranks, by key; a
        # slot rank's handles of them, by the same key
        self._fw = (forward.Forwarding(placement, self._build,
                                       handle=self._slot_op,
                                       on_event=self._on_event)
                    if forward.forwarded(placement) else None)
        self._follower = self._fw is not None and not self._fw.driver
        self._keys = itertools.count()
        self._carried: Dict[int, LMStream] = {}   # key -> client stream
        self._where: Dict[int, object] = {}        # key -> decode handle
        self._hops: Dict[int, tuple] = {}          # key -> pending hop
        self._hop_q: queue.Queue = queue.Queue()
        self._hop_thread = None
        self._slot_lock = threading.Lock()
        self._slot_streams: Dict[int, LMStream] = {}
        self._slot_cancelled: set = set()
        # the decode pool first: the migrate callback needs a target
        # before any prefill replica can finish a request
        self.decode: List[LMServingEngine] = []
        self.prefill: List[LMServingEngine] = []
        err = None
        try:
            for i in range(decode_replicas):
                self._add(self.decode, self._make_engine("decode", i))
            for i in range(prefill_replicas):
                self._add(self.prefill, self._make_engine("prefill", i))
        except BaseException as e:
            err = e
        if self._fw is not None:
            # every rank's outcome: one rank's failure fails every rank
            err = self._fw.settle(err)
        if err is not None:
            for eng in self.prefill + self.decode:
                if not isinstance(eng, _ForwardedLM):
                    eng.close()
            if self._fw is not None:
                self._fw.close_engines()
            self._release_slots()
            raise err
        if self._fw is not None and self._fw.driver:
            self._hop_thread = threading.Thread(
                target=self._hop_worker, name=f"{name}-hops", daemon=True)
            self._hop_thread.start()

    @staticmethod
    def _add(pool: list, eng) -> None:
        if eng is not None:   # None: a replica this rank does not hold
            pool.append(eng)

    # -- replica construction ------------------------------------------- #
    def _make_engine(self, phase: str, idx: int, initial: bool = True):
        """Replica ``idx`` of ``phase``: its engine; in a forwarded pair,
        on the driver a :class:`_ForwardedLM` for a slot other ranks hold
        (their engines built now, or by their executors when not
        ``initial``: ``try_scale_up``), on a follower None."""
        ename = f"{self.name}-{phase}{idx}"
        slot = None
        if self.placement is not None:
            slot = self.placement.acquire(phase=phase)
            if slot is None:
                raise RuntimeError(
                    f"no free placement slot for {ename} "
                    f"({self.placement!r})")
            if not slot.holds_this_rank() and self._fw is None:
                self.placement.release(slot)
                raise forward.no_world(slot, ename)
        link = self._fw.link(slot) if self._fw is not None else None
        try:
            if link is not None:
                self._fw.add(link, phase, idx, initial=initial)
                eng = (_ForwardedLM(self, ename, phase, link)
                       if self._fw.driver else None)
            elif self._follower:
                eng = None
            else:
                eng = self._build(slot, phase, idx)
        except BaseException:
            if slot is not None:
                self.placement.release(slot)
            raise
        if slot is not None:
            self._slices[ename] = slot
        return eng

    def _build(self, slot, phase: str, idx: int):
        """This rank's engine of replica ``idx`` of ``phase`` on
        ``slot``."""
        kw = dict(self._kw)
        if phase == "prefill":
            link = self._fw.link(slot) if self._fw is not None else None
            kw["migrate"] = (self._migrate if link is None else
                             functools.partial(self._slot_migrate, link))
            metrics, prefix = self._prefill_metrics, "serving/lm/prefill/"
        else:
            if self._spec is not None:
                kw["spec"] = self._spec
            metrics, prefix = self._decode_metrics, "serving/lm/decode/"
        eng = LMServingEngine(self.model, name=f"{self.name}-{phase}{idx}",
                              placement=slot, metrics=metrics,
                              metrics_prefix=prefix, **kw)
        # a decode replica is a co-located engine from the inside; the
        # pool it serves is not
        eng.phase = phase
        return eng

    # -- the migration hop ---------------------------------------------- #
    def _pick_decode(self):
        """The least-loaded decode replica (active, adoptions pending
        and prefills in progress; for one on other ranks, the driver's
        count of the requests it carried there and not seen end)."""
        with self._lock:
            pool = list(self.decode)
        return min(pool, key=_load)

    @staticmethod
    def _match(eng, prompt0):
        """``(matched, expect)`` for a hop to decode replica ``eng``: the
        blocks its radix holds, retained for the adoption (a replica of
        this process alone, as the reference), or the count its lead
        peeked, matched when the adoption is seated (a forwarded one)."""
        if isinstance(eng, _ForwardedLM):
            return [], eng.peek(prompt0)
        return (eng.radix.match(prompt0) if eng.radix is not None
                else []), None

    def _export(self, h: KVHandoff, src_pool, tail, dst: str):
        """The tail's wire payload under ``with_backoff`` at the
        ``serving.migrate`` fault site; None when the wire is lost."""
        def export():
            fault_point("serving.migrate", rid=h.rid, src=h.src_name,
                        dst=dst, blocks=len(tail))
            return src_pool.export_chain(tail)

        try:
            return with_backoff(
                export, retries=self.migrate_retries,
                base_delay_s=self.migrate_base_delay_s,
                label=f"{self.name}.migrate")
        except BackendLostError:
            # the wire is gone mid-hop: the decode replica recomputes the
            # chain (deterministic prefill, the first token carried)
            log.warning("%s: migrate payload lost for %s; decode replica "
                        "%s will re-prefill", self.name, h.rid, dst)
            return None

    def _migrate(self, h: KVHandoff, blocks, src_pool) -> None:
        """The prefill engines' callback, on ITS worker with the chain's
        references held: pick a decode replica, match its radix, wire the
        unmatched tail across, enqueue the adoption."""
        eng = self._pick_decode()
        t = int(h.prompt0.shape[0])
        n_prompt = src_pool.blocks_for(t)
        # the matched blocks stay retained in the DECODE pool for the
        # adoption: the part of the chain that need not travel
        matched, expect = self._match(eng, h.prompt0)
        tail = list(blocks[len(matched) if expect is None else expect:
                           n_prompt])
        try:
            h.payload = self._export(h, src_pool, tail, eng.name)
        except BaseException:
            if matched:
                eng.pool.release(matched)
            raise
        h.matched, h.expect = matched, expect
        self._adopt(eng, h)

    def _adopt(self, eng, h: KVHandoff) -> None:
        """Hand ``h`` to decode replica ``eng`` and count the hop."""
        try:
            eng.adopt(h)
        except BaseException:
            if h.matched:
                eng.pool.release(h.matched)
            raise
        with self._lock:
            self.migrations += 1
            if h.payload is None:
                self.lost_payloads += 1
            else:
                self.migrated_blocks += int(h.payload["blocks"])
                self.migrated_bytes += int(h.payload["k"].nbytes
                                           + h.payload["v"].nbytes)

    # -- forwarding: the driver's side ------------------------------------ #
    def _carry(self, stream: LMStream, link, handle=None) -> int:
        """Track ``stream`` as carried to ``link``'s slot: its tokens and
        end come back through the channel, a cancel goes out through it.
        Returns the request's key."""
        key = getattr(stream, "_fwd_key", None)
        if key is None:
            key = stream._fwd_key = next(self._keys)
        with self._lock:
            self._carried[key] = stream
            if handle is not None:
                self._where[key] = handle
        stream._wake_cb = lambda: link.post("cancel", key)
        return key

    def _on_event(self, link, msg) -> None:
        """A slot lead's message, on its channel's receiver thread:
        tokens and ends go to the client's stream at once, the hop's
        steps to the hop worker (in order)."""
        kind, key = msg[0], msg[1]
        if kind in ("handoff", "payload"):
            self._hop_q.put(msg + (link,))
            return
        with self._lock:
            stream = self._carried.get(key)
            if kind == "end":
                self._carried.pop(key, None)
                handle = self._where.pop(key, None)
                hop = self._hops.pop(key, None)
                if handle is not None:
                    handle.inflight -= 1
        if kind == "end" and hop is not None and hop[1]:
            hop[0].pool.release(hop[1])
        if stream is None:
            return
        if kind == "tok":
            stream._emit(msg[2])
        elif kind == "end":
            _, _, reason, err = msg
            if err is not None:
                stream._finish(error=forward.decode_error(err))
            elif reason is not None:
                stream._finish_truncated(reason)
            else:
                stream._finish()

    def _hop_worker(self) -> None:
        """The driver's thread for hops out of prefill replicas on other
        ranks: a ``handoff`` picks the decode replica and answers the
        prefill lead with the blocks it need not export; the
        ``payload`` then goes to that replica."""
        while True:
            msg = self._hop_q.get()
            if msg is None:
                return
            kind, key = msg[0], msg[1]
            try:
                if kind == "handoff":
                    fields, link = msg[2], msg[3]
                    eng = self._pick_decode()
                    matched, expect = self._match(eng, fields["prompt0"])
                    with self._lock:
                        self._hops[key] = (eng, matched, expect, fields)
                    link.answer(key, ("ok", len(matched) if expect is None
                                      else expect, eng.name))
                    continue
                with self._lock:
                    hop = self._hops.pop(key, None)
                    stream = self._carried.get(key)
                if hop is None or stream is None:
                    continue   # the request ended meanwhile
                eng, matched, expect, fields = hop
                h = KVHandoff.carried(stream, fields)
                h.payload, h.matched, h.expect = msg[2], matched, expect
                if not isinstance(eng, _ForwardedLM):
                    with self._lock:
                        self._carried.pop(key, None)
                self._adopt(eng, h)
            except Exception as e:  # noqa: BLE001 - fail this request
                log.exception("%s: hop of request %s failed", self.name,
                              key)
                if kind == "handoff":
                    msg[3].answer(key, ("err", forward.encode_error(e)))
                with self._lock:
                    stream = self._carried.pop(key, None)
                    hop = self._hops.pop(key, None)
                if hop is not None and hop[1]:
                    hop[0].pool.release(hop[1])
                if stream is not None:
                    stream._finish(error=e)

    # -- forwarding: a slot rank's side ----------------------------------- #
    def _slot_op(self, link, eng: LMServingEngine, op: str, *args):
        """A slot rank's handler of the driver's ops (run in order on the
        channel's executor thread): a submission or an adoption becomes
        this rank's handle of the request, which the lead relays; a
        cancel reaches it, or waits for it; the rest are the engine's."""
        if op == "submit":
            key, prompt, kw = args
            with self._slot_lock:
                self._slot_carry(link, key, eng.forwarded("submit", prompt,
                                                          kw))
            return None
        if op == "adopt":
            key, fields, payload, expect, cancelled = args
            with self._slot_lock:
                stream = eng.forwarded("adopt", fields, payload, expect)
                self._slot_carry(link, key, stream)
            if cancelled:
                stream.cancel()
            return None
        if op == "cancel":
            with self._slot_lock:
                stream = self._slot_streams.get(args[0])
                if stream is None:
                    # it has not arrived yet (or already ended)
                    self._slot_cancelled.add(args[0])
            if stream is not None:
                stream.cancel()
            return None
        return eng.forwarded(op, *args)

    def _slot_carry(self, link, key, stream: LMStream) -> None:
        """Keep this rank's handle of the driver's request ``key`` (under
        ``_slot_lock``); the slot's lead relays its tokens and its end to
        the driver."""
        stream._fwd_key = key
        self._slot_streams[key] = stream
        if key in self._slot_cancelled:
            self._slot_cancelled.discard(key)
            stream.cancel()

        def relay(kind, *a):
            if kind == "end":
                self._slot_streams.pop(key, None)
            if not link.is_lead:
                return
            if kind == "tok":
                link.send_up(("tok", key, a[0]))
                return
            trunc, err = a
            link.send_up(("end", key,
                          trunc.reason if trunc is not None else None,
                          forward.encode_error(err) if err is not None
                          else None))
        stream._observe(relay)

    def _slot_migrate(self, link, h: KVHandoff, blocks, src_pool) -> None:
        """The migrate callback of a prefill engine on a slot rank: every
        rank of the slot gets the same handoff; the lead asks the driver
        which blocks the decode replica holds, exports the rest and
        sends the payload (None when lost) up."""
        with self._slot_lock:   # the submit that made it is registered
            key = h.stream._fwd_key
            self._slot_streams.pop(key, None)
        if not link.is_lead:
            return
        n_prompt = src_pool.blocks_for(int(h.prompt0.shape[0]))
        answer = link.ask(key, ("handoff", key, h.fields()))
        if answer[0] == "err":
            raise forward.decode_error(answer[1])
        _, skip, dst = answer
        payload = self._export(h, src_pool, list(blocks[skip:n_prompt]),
                               dst)
        link.send_up(("payload", key, payload))

    def _stop_forwarding(self) -> None:
        """The driver stops every channel (each slot's ranks close what
        they hold) and its hop worker; any other rank waits until the
        driver did."""
        try:
            self._fw.shutdown()
        finally:
            if self._hop_thread is not None:
                self._hop_q.put(None)
                self._hop_thread.join()
                self._hop_thread = None

    # -- client API ------------------------------------------------------ #
    def submit(self, prompt_ids, *, max_new_tokens=None, temperature=None,
               eos_id=None, rng=None) -> LMStream:
        """Enqueue one prompt on a prefill replica (round-robin); the
        stream completes on whichever decode replica adopts the chain."""
        if self._follower:
            self._fw.require_driver("DisaggCoordinator.submit")
        with self._lock:
            if self._closing:
                raise ServingClosed("DisaggCoordinator is closed")
            eng = self.prefill[self._rr % len(self.prefill)]
            self._rr += 1
        return eng.submit(prompt_ids, max_new_tokens=max_new_tokens,
                          temperature=temperature, eos_id=eos_id, rng=rng)

    def warmup(self) -> int:
        """Make every replica's entries before traffic (a prefill replica
        skips the decode step), and run each decode replica's adopt path
        once per power-of-two wire width up to its table width, so the
        first hop of each width pays no first use.  Returns the number of
        entries and widths made (in a forwarded pair the driver's call
        warms every slot: on any other rank, 0)."""
        n = 0
        with self._lock:
            engines = self.prefill + self.decode
            decode = list(self.decode)
        for eng in engines:
            n += eng.warmup()
        for eng in decode:
            widths, w = [], 1
            while w < eng.table_width:
                widths.append(w)
                w *= 2
            widths.append(w)
            if isinstance(eng, _ForwardedLM):
                n += eng.warmup_adopt(widths)
                continue
            n += eng.pool.warmup_adopt(widths)
            eng._follow_caller()
        return n

    # -- independent phase scaling --------------------------------------- #
    def try_scale_up(self, phase: str) -> bool:
        """Add one replica to ``phase`` ("prefill" or "decode").  False,
        without side effects, when the phase is at its ceiling, the
        placement policy has no free slot or the coordinator is closing:
        the SLO ladder then falls through to admission control.  The new
        replica is built cold: call its ``warmup()`` before it takes
        traffic to keep captures out of requests."""
        if phase not in ("prefill", "decode"):
            raise ValueError(f"unknown phase {phase!r}")
        if self._follower:
            self._fw.require_driver("DisaggCoordinator.try_scale_up")
        with self._scale_lock:
            with self._lock:
                if self._closing:
                    return False
                pool = self.prefill if phase == "prefill" else self.decode
                idx = len(pool)
                if idx >= self.max_replicas_per_phase:
                    return False
                if (self.placement is not None
                        and self.placement.headroom() == 0):
                    return False
            try:
                eng = self._make_engine(phase, idx, initial=False)
            except RuntimeError as e:
                if "no free placement slot" not in str(e):
                    raise
                return False   # raced out of the last placement slot
            with self._lock:
                pool.append(eng)
        metrics = (self._prefill_metrics if phase == "prefill"
                   else self._decode_metrics)
        with metrics._lock:
            metrics.slots += eng.slots
        log.info("%s: scaled %s pool to %d replicas", self.name, phase,
                 idx + 1)
        _tracer.instant("disagg/scale_up", cat="serve", phase=phase,
                        replicas=idx + 1)
        return True

    def slo_controllers(self, *, ttft_target_s: float, itl_target_s: float,
                        **ctl_kwargs):
        """Two ladders over the per-phase histograms: the windowed TTFT
        p99 grows the prefill pool, the windowed decode-gap p99 the
        decode pool.  Extra kwargs go to both
        :class:`~bigdl_tpu_torch.traffic.slo.SLOController` s, returned
        unstarted."""
        from bigdl_tpu_torch.traffic.slo import SLOController
        ttft_ctl = SLOController(
            histogram=self._prefill_metrics.ttft,
            target_p99_s=ttft_target_s,
            scale_up=lambda: self.try_scale_up("prefill"), **ctl_kwargs)
        itl_ctl = SLOController(
            histogram=self._decode_metrics.itl_decode,
            target_p99_s=itl_target_s,
            scale_up=lambda: self.try_scale_up("decode"), **ctl_kwargs)
        return ttft_ctl, itl_ctl

    # -- observability ---------------------------------------------------- #
    @property
    def prefill_metrics(self) -> LMMetrics:
        return self._prefill_metrics

    @property
    def decode_metrics(self) -> LMMetrics:
        return self._decode_metrics

    @property
    def metrics(self) -> LMMetrics:
        """The decode pool's metrics: the client-visible cadence (gaps,
        tokens/s, completions) lives where decode runs."""
        return self._decode_metrics

    @property
    def decode_attn(self) -> str:
        return self.decode[0].decode_attn

    def stats(self) -> dict:
        with self._lock:
            out = {
                "name": self.name,
                "prefill_replicas": len(self.prefill),
                "decode_replicas": len(self.decode),
                "migrations": self.migrations,
                "migrated_blocks": self.migrated_blocks,
                "migrated_bytes": self.migrated_bytes,
                "lost_payloads": self.lost_payloads,
            }
            engines = self.prefill + self.decode
            decode = list(self.decode)
        # a replica on other ranks answers over its channel
        per = {e.name: e.stats() for e in engines}
        out["re_prefills"] = sum(per[e.name]["re_prefills"] for e in decode)
        out["adopted"] = sum(per[e.name]["adopted"] for e in decode)
        out["phase_counts"] = (self.placement.phase_counts()
                               if self.placement is not None else None)
        out["prefill"] = self._prefill_metrics.snapshot()
        out["decode"] = self._decode_metrics.snapshot()
        out["engines"] = per
        if self._follower:
            out["local"] = {sid: e.stats()
                            for sid, e in self._fw.engines.items()}
        return out

    # -- lifecycle -------------------------------------------------------- #
    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Drain the prefill replicas first (their last requests migrate
        out), then the decode replicas, then release the placement
        slots.  A forwarded pair's rank other than the driver returns
        once the driver's close has drained the pair."""
        with self._scale_lock, self._lock:
            if self._closing:
                return
            self._closing = True
            prefill, decode = list(self.prefill), list(self.decode)
        for eng in prefill:
            eng.close(timeout)
        for eng in decode:
            eng.close(timeout)
        try:
            if self._fw is not None:
                self._stop_forwarding()
        finally:
            self._release_slots()

    def _release_slots(self) -> None:
        for ename, slot in self._slices.items():
            try:
                self.placement.release(slot)
            except Exception:
                log.exception("releasing %s's slot failed", ename)
        self._slices.clear()

    def __enter__(self) -> "DisaggCoordinator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _load(eng) -> int:
    if isinstance(eng, _ForwardedLM):
        return eng.inflight
    return eng._n_active + len(eng._adopt_q) + len(eng._prefilling)


class _ForwardedLM:
    """The driver's handle on a forwarded replica: its slot's ranks hold
    the engine (the driver among them when it holds the slot: its engine
    then runs on the channel's executor like theirs).  Submissions and
    adoptions go to the slot's ranks in the channel's order; the client's
    stream is fed by the lead's relay."""

    def __init__(self, owner: DisaggCoordinator, name: str, phase: str,
                 link):
        self.owner = owner
        self.name = name
        self.phase = phase
        self.link = link
        self.inflight = 0      # carried adoptions not seen end

    @functools.cached_property
    def _desc(self) -> dict:
        return self.link.control("describe")

    @property
    def slots(self) -> int:
        return self._desc["slots"]

    @property
    def table_width(self) -> int:
        return self._desc["table_width"]

    @property
    def decode_attn(self) -> str:
        return self._desc["decode_attn"]

    def submit(self, prompt_ids, **kw) -> LMStream:
        prompt = np.asarray(prompt_ids).reshape(-1).astype(np.int32)
        max_new = kw.get("max_new_tokens")
        stream = LMStream(prompt, int(max_new if max_new is not None
                                      else self._desc["max_new_tokens"]))
        key = self.owner._carry(stream, self.link)
        try:
            self.link.call("submit", key, prompt_ids, kw)
        except BaseException:
            with self.owner._lock:
                self.owner._carried.pop(key, None)
            raise
        return stream

    def peek(self, prompt0) -> int:
        return self.link.call("peek", prompt0)

    def adopt(self, h: KVHandoff) -> None:
        # tracked before it leaves: its first tokens may come back before
        # the post returns
        with self.owner._lock:
            self.inflight += 1
        key = self.owner._carry(h.stream, self.link, handle=self)
        self.link.post("adopt", key, h.fields(), h.payload, h.expect,
                       h.stream.cancel_requested)

    def warmup(self) -> int:
        return self.link.control("warmup")

    def warmup_adopt(self, widths) -> int:
        return self.link.control("warmup_adopt", widths)

    def stats(self) -> dict:
        return self.link.call("stats")

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """The replica leaves its slot (the channel stays until the
        coordinator closes)."""
        self.link.control("drop", timeout)
