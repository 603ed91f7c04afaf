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
the hop already goes through host memory.  Every slot must hold this
process (a phase on other ranks would need the hop carried between
processes, ROADMAP Queue 1 item 11.8).
"""
from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from bigdl_tpu_torch.obs import get_tracer
from bigdl_tpu_torch.resilience.errors import BackendLostError
from bigdl_tpu_torch.resilience.faults import fault_point
from bigdl_tpu_torch.resilience.retry import with_backoff
from bigdl_tpu_torch.serving.errors import ServingClosed
from bigdl_tpu_torch.serving.lm_engine import (KVHandoff, LMMetrics,
                                               LMServingEngine, LMStream)

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
            rather than stacking it on a held slot.  None: every replica
            on the model's device.
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
        self._slices: Dict[str, object] = {}   # engine name -> MeshSlice
        self._rr = 0                           # round-robin submit cursor
        self.migrations = 0
        self.migrated_blocks = 0
        self.migrated_bytes = 0                # wire bytes, k and v
        self.lost_payloads = 0
        self._closing = False
        # the decode pool first: the migrate callback needs a target
        # before any prefill replica can finish a request
        self.decode: List[LMServingEngine] = []
        self.prefill: List[LMServingEngine] = []
        try:
            for i in range(decode_replicas):
                self.decode.append(self._make_engine("decode", i))
            for i in range(prefill_replicas):
                self.prefill.append(self._make_engine("prefill", i))
        except BaseException:
            for eng in self.prefill + self.decode:
                eng.close()
            self._release_slots()
            raise

    # -- replica construction ------------------------------------------- #
    def _make_engine(self, phase: str, idx: int) -> LMServingEngine:
        ename = f"{self.name}-{phase}{idx}"
        slot = None
        if self.placement is not None:
            from bigdl_tpu_torch.serving.placement import PlacementError
            slot = self.placement.acquire(phase=phase)
            if slot is None:
                raise RuntimeError(
                    f"no free placement slot for {ename} "
                    f"({self.placement!r})")
            if not slot.holds_this_rank():
                self.placement.release(slot)
                raise PlacementError(
                    f"{slot!r} for {ename} is held by ranks "
                    f"{list(slot.ranks)}, not by this process: a phase on "
                    "other ranks needs the hop carried between processes "
                    "(ROADMAP Queue 1 item 11.8)")
        kw = dict(self._kw)
        if phase == "prefill":
            kw["migrate"] = self._migrate
            metrics, prefix = self._prefill_metrics, "serving/lm/prefill/"
        else:
            if self._spec is not None:
                kw["spec"] = self._spec
            metrics, prefix = self._decode_metrics, "serving/lm/decode/"
        try:
            eng = LMServingEngine(self.model, name=ename, placement=slot,
                                  metrics=metrics, metrics_prefix=prefix,
                                  **kw)
        except BaseException:
            if slot is not None:
                self.placement.release(slot)
            raise
        if slot is not None:
            self._slices[ename] = slot
        # a decode replica is a co-located engine from the inside; the
        # pool it serves is not
        eng.phase = phase
        return eng

    # -- the migration hop ---------------------------------------------- #
    def _pick_decode(self) -> LMServingEngine:
        """The least-loaded decode replica (active, adoptions pending
        and prefills in progress)."""
        with self._lock:
            pool = list(self.decode)
        return min(pool, key=lambda e: (e._n_active + len(e._adopt_q)
                                        + len(e._prefilling)))

    def _migrate(self, h: KVHandoff, blocks, src_pool) -> None:
        """The prefill engines' callback, on ITS worker with the chain's
        references held: pick a decode replica, match its radix, wire the
        unmatched tail across, enqueue the adoption."""
        eng = self._pick_decode()
        t = int(h.prompt0.shape[0])
        n_prompt = src_pool.blocks_for(t)
        # the matched blocks stay retained in the DECODE pool for the
        # adoption: the part of the chain that need not travel
        matched = eng.radix.match(h.prompt0) if eng.radix is not None \
            else []
        tail = list(blocks[len(matched):n_prompt])

        def export():
            fault_point("serving.migrate", rid=h.rid, src=h.src_name,
                        dst=eng.name, blocks=len(tail))
            return src_pool.export_chain(tail)

        try:
            h.payload = with_backoff(
                export, retries=self.migrate_retries,
                base_delay_s=self.migrate_base_delay_s,
                label=f"{self.name}.migrate")
        except BackendLostError:
            # the wire is gone mid-hop: the decode replica recomputes the
            # chain (deterministic prefill, the first token carried)
            log.warning("%s: migrate payload lost for %s; decode replica "
                        "%s will re-prefill", self.name, h.rid, eng.name)
            h.payload = None
        except BaseException:
            if matched:
                eng.pool.release(matched)
            raise
        h.matched = matched
        try:
            eng.adopt(h)
        except BaseException:
            if matched:
                eng.pool.release(matched)
            raise
        with self._lock:
            self.migrations += 1
            if h.payload is None:
                self.lost_payloads += 1
            else:
                self.migrated_blocks += int(h.payload["blocks"])
                self.migrated_bytes += int(h.payload["k"].nbytes
                                           + h.payload["v"].nbytes)

    # -- client API ------------------------------------------------------ #
    def submit(self, prompt_ids, *, max_new_tokens=None, temperature=None,
               eos_id=None, rng=None) -> LMStream:
        """Enqueue one prompt on a prefill replica (round-robin); the
        stream completes on whichever decode replica adopts the chain."""
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
        entries and widths made."""
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
        with self._lock:
            if self._closing:
                return False
            pool = self.prefill if phase == "prefill" else self.decode
            idx = len(pool)
            if idx >= self.max_replicas_per_phase:
                return False
            if self.placement is not None and self.placement.headroom() == 0:
                return False
            try:
                eng = self._make_engine(phase, idx)
            except RuntimeError as e:
                if "no free placement slot" not in str(e):
                    raise
                return False   # raced out of the last placement slot
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
        out["re_prefills"] = sum(e.re_prefills for e in decode)
        out["adopted"] = sum(e.adopted for e in decode)
        out["phase_counts"] = (self.placement.phase_counts()
                               if self.placement is not None else None)
        out["prefill"] = self._prefill_metrics.snapshot()
        out["decode"] = self._decode_metrics.snapshot()
        out["engines"] = {e.name: e.stats() for e in engines}
        return out

    # -- lifecycle -------------------------------------------------------- #
    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Drain the prefill replicas first (their last requests migrate
        out), then the decode replicas, then release the placement
        slots."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
            prefill, decode = list(self.prefill), list(self.decode)
        for eng in prefill:
            eng.close(timeout)
        for eng in decode:
            eng.close(timeout)
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
