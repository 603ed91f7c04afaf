"""LM serving: continuous batching over a paged, prefix-shared KV cache
(port of ``bigdl_tpu/serving/lm_engine.py``, its core).

- **prefill**: a new request's prompt runs through a bucketed prefill
  (prompt padded to a power-of-two bucket).  A cold prompt runs the
  plain prefill, whose attention is the CUDA flash kernel on the card;
  a prompt whose head is cached in the :class:`RadixCache` prefills only
  the unmatched SUFFIX against the cached chain; prompts longer than the
  largest bucket prefill in block-aligned chunks through the suffix
  path.
- **insert**: each chunk's k/v rows are scattered into its blocks of
  the (L, num_blocks, H, block_len, D) arenas, in place.
- **decode**: one step advances every occupied slot at its own
  position; attention reads each slot's chain through a padded int32
  block table, in place through the CUDA paged kernel on the card.
- **int8 KV** (``kv_quant="int8"``): the arenas hold int8 rows with a
  float32 scale per (position, head); every step quantizes the rows it
  writes and dequantizes inside the dense gather, so decode uses the
  gather (the paged kernel reads float arenas, as the reference's
  does).

- **sampling**: at ``temperature > 0`` each token is drawn on the host
  from the logits row, with the key chain offline ``generate`` uses.
- **speculation** (``spec=SpecConfig(...)`` or ``spec=k``): a drafter
  (by default the target's int8 ``quantize()`` clone) proposes k tokens
  per slot and one verify step scores every candidate row (or a
  candidate tree's nodes) against the arenas; the host accepts the
  prefix that matches the offline draws.

A quantized target (``model.quantize("int8")``) serves from its int8
storage: each step expands one layer's dequant-mode weights at a time
and sends int8-compute weights to the int8 product
(``quant.qmatmul``).

A slot's stream, greedy or sampled, speculative or not, is the
computation offline ``generate`` runs at batch 1: cached prefix keys
are stored post-RoPE, bucket padding and stale rows are masked by
position, and every draw replays the request's key chain.  Ids are
1-based at ``submit`` and in the streams, 0-based inside.

Every device step has a fixed shape and runs through an entry of
``serving/compile_cache.py``: on a CUDA device a captured CUDA graph,
replayed with its inputs copied into static buffers (``cuda_graphs``).
The contract is the reference's bounded one: one prefill entry per
bucket (``prefill_cache``, the block insert inside), one per (suffix
bucket, prefix-chain bucket) pair (``prefix_prefill_cache``, made ahead
by :meth:`LMServingEngine.warmup_prefix`), one decode step, one linear
verify step or one per tree rung (``_verify_compiles``), one tree
commit (``_commit_compiles``), and the drafter's own decode and prefill
entries.  Host draws, the acceptance walks and the radix bookkeeping
stay outside every graph.

One worker thread owns every launch and replay after warmup; it selects
the engine's device before its first launch and brings logits to the
host with ``.cpu()`` (which synchronises) before the next replay, since
a graph's outputs live in a pool the next graph reuses.

- **lifecycle**: ``submit(deadline_s=)`` arms a wall-clock budget at
  enqueue and ``LMStream.cancel()`` asks to stop; both are honored at
  the next scheduler round.  A request still queued when its budget
  runs out is shed with :class:`ServingDeadlineExceeded`; a seated
  stream is finished with a typed :class:`StreamTruncation` (its tokens
  the exact prefix of the full answer), its slot and blocks recycled.
  A cancel wakes an idle worker, and an idle worker still wakes for the
  earliest deadline among queued, resuming and hibernated streams.
- **host KV tier** (``kvtier=HostBlockStore(...)``): radix-tail eviction
  demotes each victim block to host RAM instead of dropping it, an
  admission promotes any surviving continuation of its matched prefix
  back (prefilling only past it), and :meth:`LMServingEngine.hibernate`
  / :meth:`LMServingEngine.resume` swap a whole stream out of its slot
  and back, bit-exactly.  A lost payload re-prefills the prompt and
  replays the emitted tokens through the decode step without emitting
  them again (counted in ``resume_re_prefills``).  Every move is in
  place on the arenas, whose addresses the graphs captured.
- **observability**: ``LMMetrics`` (``serving/lm/*``), the KV plane
  (``kvcache/*``), ``SpecMetrics`` (``serving/lm/spec/*``) and the
  lifecycle counters (``serving/lifecycle/*``) publish into the
  process-wide registry (``bigdl_tpu_torch.obs``); every request gets
  an id, and a sampled one records ``lm/*`` spans and instants on the
  host clock.  Fault sites: ``serving.enqueue`` (a transient becomes
  :class:`ServingOverloaded`), ``serving.verify`` (a transient demotes
  the speculating slots for the round) and ``serving.cancel`` (a fault
  cancels the stream).

- **chunked-prefill interleave** (``max_prefill_chunk_tokens``): an
  admitted prompt prefills in block-aligned chunks of at most that many
  tokens, ONE chunk per scheduler round between decode rounds, so a
  long prompt arriving mid-decode stalls every active stream by one
  chunk, not one prompt (Sarathi).  Chunks after the first run the
  suffix prefill against the chain written so far; streams do not
  change.
- **disaggregated phases** (``serving/disagg``): an engine built with
  ``migrate=callback`` is a prefill replica: after a request's first
  token it builds a :class:`KVHandoff` and calls ``migrate(handoff,
  blocks, pool)`` on its worker (the chain still referenced), and the
  request leaves it.  A decode replica takes it through :meth:`adopt`:
  its worker adopts the wire payload into its own arenas (or
  re-prefills the prompt when the payload was lost, never emitting the
  first token again) and decodes on from the handoff's state.
  Adoptions rank ahead of resumes and fresh admissions.
- **replica sets**: engines of one model share its parameter tensors
  (read-only; each engine's graphs captured their addresses);
  ``metrics=``/``metrics_prefix=`` let replicas publish one shared
  :class:`LMMetrics`; ``set_slot_limit``/``set_max_queue`` are the SLO
  controller's actuators; :meth:`attach_radix_summary` publishes the
  trie's prefix fingerprints to a router.

On a CUDA device every engine's worker launches on a stream of its own
(never the legacy default stream), made to wait for the constructing
thread's stream at construction and for the caller's after ``warmup()``
and ``warmup_prefix()``: several engines on one card replay and copy
side by side while another captures.  The kernels' launches made by a
worker are also counted per engine (:meth:`LMServingEngine.\
kernel_launches`).

Observability: the engine attributes its arenas, staged params,
drafter arena and graph pool to the memory ledger
(:mod:`bigdl_tpu_torch.obs.ledger`; released on :meth:`close`), defers
an admission while the ledger reads the device past its watermark
(one ``mem_pressure`` flight bundle), and registers its ``stats()`` and
request ids with the flight recorder as ``lm_engine/<name>``.

Not ported yet, and refused with ``NotImplementedError`` when asked
for: ``placement`` (ROADMAP Queue 1 item 11.7).
"""
from __future__ import annotations

import copy
import logging
import threading
import time
import weakref
from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.models.transformer.generate import (
    _decode_step_paged, _insert_blocks, _prefill_parts,
    _prefill_suffix_parts, _tree_commit_paged, _tree_verify_step_paged,
    _verify_step_paged)
from bigdl_tpu_torch.quant.transform import (params_dtype_tag,
                                             set_compute_mode)
from bigdl_tpu_torch.serving.compile_cache import (CompileCache, GraphPool,
                                                   StepGraph, _dtype_name)
from bigdl_tpu_torch.obs import get_registry, get_tracer, mint_request_id
from bigdl_tpu_torch.obs.registry import FnGauge, Histogram
from bigdl_tpu_torch.ops import KERNELS, autotune, resolve_attention_plan
from bigdl_tpu_torch.ops._build import tally_launches
from bigdl_tpu_torch.resilience.faults import fault_point
from bigdl_tpu_torch.serving.errors import (BackendLostError, PoolExhausted,
                                            RequestExceedsPool, ServingClosed,
                                            ServingDeadlineExceeded,
                                            ServingOverloaded,
                                            ServingQueueFull,
                                            TransientBackendError,
                                            count_rejection)
from bigdl_tpu_torch.serving.kvcache import BlockPool, RadixCache
from bigdl_tpu_torch.serving.kvtier.store import block_path
from bigdl_tpu_torch.serving.spec import (DraftModel, NgramDrafter,
                                          SpecConfig, SpecMetrics)
from bigdl_tpu_torch.serving.spec.verify import accept_row, pick_token
from bigdl_tpu_torch.utils import keychain

log = logging.getLogger("bigdl_tpu_torch.serving")

_tracer = get_tracer()


def prefill_bucket_lengths(max_len: int, min_bucket: int = 8) -> tuple:
    """Power-of-two prompt-length buckets up to (and including) a
    non-power-of-two ``max_len`` cap."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    buckets = []
    b = max(1, int(min_bucket))
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(int(max_len))
    return tuple(sorted(set(buckets)))


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


# ---------------------------------------------------------------------- #
class StreamTruncation:
    """Why and where the lifecycle layer ended a stream early (attached
    as ``LMStream.truncation``): a deadline that ran out mid-decode or a
    cooperative cancel.  The tokens already emitted stay valid and
    bit-exact; the stream completes without an error.  ``reason`` is
    ``"deadline"`` or ``"cancelled"``."""

    __slots__ = ("reason", "at_tokens", "deadline_s")

    def __init__(self, reason: str, at_tokens: int,
                 deadline_s: Optional[float] = None):
        self.reason = str(reason)
        self.at_tokens = int(at_tokens)  # generated length at truncation
        self.deadline_s = deadline_s     # original budget, if any

    def __repr__(self):
        return (f"StreamTruncation(reason={self.reason!r}, "
                f"at_tokens={self.at_tokens})")


class LMStream:
    """Per-request handle: generated 1-based ids stream in as the engine
    decodes them.  ``tokens()`` iterates them as they land;
    ``result()`` blocks for prompt + generated ids.

    Lifecycle: an optional wall-clock budget (``deadline_s``, armed at
    enqueue; the absolute deadline rides every hibernate/resume hop) and
    :meth:`cancel`.  Both are cooperative: the engine honors them at its
    next scheduler round and finishes the stream with a
    :class:`StreamTruncation` (``result()`` returns the tokens so far
    without raising)."""

    def __init__(self, prompt_1b: np.ndarray, max_new: int,
                 request_id: Optional[str] = None,
                 deadline_s: Optional[float] = None):
        self.prompt = prompt_1b
        self.max_new = int(max_new)
        self.request_id = request_id    # trace and host-tier handle
        self._tokens: List[int] = []
        self._cond = threading.Condition()
        self._done = False
        self._error: Optional[BaseException] = None
        self.submitted_at = time.perf_counter()
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.deadline_s = (float(deadline_s)
                           if deadline_s is not None else None)
        self.deadline_at = ((time.monotonic() + self.deadline_s)
                            if self.deadline_s is not None else None)
        self.truncation: Optional[StreamTruncation] = None
        self._cancel_requested = False
        self._cancel_at_gen = 0         # generated length when cancelled
        self._wake_cb = None            # engine nudge, set at enqueue

    # lifecycle --------------------------------------------------------- #
    def cancel(self) -> bool:
        """Ask the engine to stop this request (the client went away).
        Returns True if the request was still live; the engine honors it
        at its next scheduler round.  Idempotent, safe from any
        thread."""
        with self._cond:
            if self._done:
                return False
            if not self._cancel_requested:
                self._cancel_requested = True
                self._cancel_at_gen = len(self._tokens)
            cb = self._wake_cb
        if cb is not None:
            try:
                cb()
            except Exception:   # a closing engine must not fail cancel
                pass
        return True

    @property
    def cancel_requested(self) -> bool:
        with self._cond:
            return self._cancel_requested

    def expired(self, now: Optional[float] = None) -> bool:
        """True once the wall-clock budget is spent."""
        if self.deadline_at is None:
            return False
        return (now if now is not None else time.monotonic()) \
            >= self.deadline_at

    def dead(self, now: Optional[float] = None) -> bool:
        """True once cancelled or past its deadline: the engine retires
        the stream at its next round boundary."""
        return self.cancel_requested or self.expired(now)

    def remaining_s(self, now: Optional[float] = None) -> Optional[float]:
        """Budget left (seconds; may be negative), or None if unbounded."""
        if self.deadline_at is None:
            return None
        return self.deadline_at - (now if now is not None
                                   else time.monotonic())

    # engine-side ------------------------------------------------------- #
    def _emit(self, token_1b: int) -> None:
        with self._cond:
            if self.first_token_at is None:
                self.first_token_at = time.perf_counter()
            self._tokens.append(int(token_1b))
            self._cond.notify_all()

    def _finish(self, error: Optional[BaseException] = None) -> None:
        with self._cond:
            if self._done:
                return
            self._done = True
            self._error = error
            self.finished_at = time.perf_counter()
            # a finished stream wakes nothing: a client holding it must
            # not keep a closed engine (and its arenas) alive
            self._wake_cb = None
            self._cond.notify_all()

    def _finish_truncated(self, reason: str) -> None:
        """Finish early with a truncation marker (no error)."""
        with self._cond:
            if self._done:
                return
            if self.truncation is None:
                self.truncation = StreamTruncation(
                    reason, len(self._tokens), self.deadline_s)
        self._finish()

    # client-side ------------------------------------------------------- #
    def tokens(self, timeout: Optional[float] = None):
        """Yield generated 1-based token ids as they arrive."""
        deadline = (time.perf_counter() + timeout) if timeout else None
        i = 0
        while True:
            with self._cond:
                while len(self._tokens) <= i and not self._done:
                    left = (deadline - time.perf_counter()) if deadline \
                        else None
                    if left is not None and left <= 0:
                        raise TimeoutError("LMStream.tokens timed out")
                    self._cond.wait(left)
                if len(self._tokens) > i:
                    tok = self._tokens[i]
                    i += 1
                elif self._error is not None:
                    raise self._error
                else:
                    return
            yield tok

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until done; return prompt + generated ids (1-based)."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise TimeoutError("LMStream.result timed out")
            if self._error is not None:
                raise self._error
            gen = np.asarray(self._tokens, np.int32)
        return np.concatenate([self.prompt, gen])

    def done(self) -> bool:
        with self._cond:
            return self._done

    @property
    def generated(self) -> np.ndarray:
        with self._cond:
            return np.asarray(self._tokens, np.int32)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


# ---------------------------------------------------------------------- #
class LMMetrics:
    """Serving counters and latency histograms; thread-safe (the
    decode worker records, callers and the registry read).

    ITL is split by phase: ``itl`` holds every gap, ``itl_decode`` the
    gaps between back-to-back decode rounds, ``itl_prefill_gap`` those a
    prefill or a resume interrupted."""

    def __init__(self, slots: int, throughput_window_s: float = 60.0):
        self._lock = threading.Lock()
        self.slots = int(slots)
        self.ttft = Histogram()
        self.itl = Histogram()
        self.itl_decode = Histogram()
        self.itl_prefill_gap = Histogram()
        self.requests = 0
        self.rejected = 0
        self.completed = 0
        self.tokens = 0
        self.prefills = 0
        self.decode_steps = 0
        self.slot_steps = 0
        self.active_slot_steps = 0
        self.peak_active = 0
        self.spec: Optional[SpecMetrics] = None  # set by a spec engine
        self.started_at = time.perf_counter()
        self._window_s = float(throughput_window_s)
        self._recent: deque = deque()  # (t, n_tokens) per decode step

    def publish_to(self, registry,
                   prefix: str = "serving/lm/") -> "LMMetrics":
        for key in ("ttft", "itl", "itl_decode", "itl_prefill_gap"):
            registry.register(prefix + key, getattr(self, key),
                              replace=True)
        for key in ("requests", "rejected", "completed", "tokens",
                    "prefills", "decode_steps"):
            registry.register(prefix + key,
                              FnGauge(lambda k=key: getattr(self, k)),
                              replace=True)
        for key in ("tokens_per_s", "slot_occupancy", "slot_occupancy_peak"):
            registry.register(prefix + key,
                              FnGauge(lambda k=key: self.snapshot()[k]),
                              replace=True)
        return self

    def record_submit(self) -> None:
        with self._lock:
            self.requests += 1

    def record_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_first_token(self, ttft_s: float) -> None:
        with self._lock:
            self.prefills += 1
            self.tokens += 1
            self.ttft.observe(ttft_s)
            self._recent.append((time.perf_counter(), 1))

    def record_step(self, n_active: int, itls_s: Sequence[float],
                    prefill_interrupted: bool = False) -> None:
        with self._lock:
            now = time.perf_counter()
            self.decode_steps += 1
            self.slot_steps += self.slots
            self.active_slot_steps += n_active
            self.peak_active = max(self.peak_active, n_active)
            self.tokens += len(itls_s)
            self._recent.append((now, len(itls_s)))
            horizon = now - self._window_s
            while self._recent and self._recent[0][0] < horizon:
                self._recent.popleft()
            split = (self.itl_prefill_gap if prefill_interrupted
                     else self.itl_decode)
            for itl in itls_s:
                self.itl.observe(itl)
                split.observe(itl)

    def record_complete(self) -> None:
        with self._lock:
            self.completed += 1

    def snapshot(self) -> dict:
        with self._lock:
            now = time.perf_counter()
            horizon = now - self._window_s
            while self._recent and self._recent[0][0] < horizon:
                self._recent.popleft()
            span = min(now - self.started_at, self._window_s)
            windowed = sum(n for _, n in self._recent)
            return {
                "requests": self.requests,
                "rejected": self.rejected,
                "completed": self.completed,
                "tokens": self.tokens,
                "prefills": self.prefills,
                "decode_steps": self.decode_steps,
                "tokens_per_s": (windowed / span) if span > 0 else 0.0,
                "slot_occupancy":
                    (self.active_slot_steps / self.slot_steps)
                    if self.slot_steps else None,
                "slot_occupancy_peak":
                    (self.peak_active / self.slots)
                    if self.slot_steps else None,
                "ttft": self.ttft.snapshot(),
                "itl": self.itl.snapshot(),
                "itl_decode": self.itl_decode.snapshot(),
                "itl_prefill_gap": self.itl_prefill_gap.snapshot(),
                "spec": (self.spec.snapshot()
                         if self.spec is not None else None),
            }


# ---------------------------------------------------------------------- #
class _Request:
    __slots__ = ("stream", "prompt0", "max_new", "temperature", "eos0",
                 "first_key", "step_keys", "rid")

    def __init__(self, stream, prompt0, max_new, temperature, eos0,
                 first_key, step_keys, rid):
        self.stream = stream
        self.prompt0 = prompt0          # (t,) int32, 0-based
        self.max_new = max_new
        self.temperature = temperature
        self.eos0 = eos0                # 0-based eos id or None
        self.first_key = first_key      # (2,) uint32 or None
        self.step_keys = step_keys      # (max_new - 1, 2) uint32 or None
        self.rid = rid                  # request id


class _Slot:
    __slots__ = ("stream", "pos_next", "last0", "remaining", "step_idx",
                 "temperature", "eos0", "step_keys", "last_emit_at",
                 "blocks", "table", "draft_ok", "demoted", "accept_ema",
                 "spec_rounds", "probe_in", "tree_rung", "rid", "replay")

    def __init__(self, req: _Request, prompt_len: int, first0: int,
                 blocks: List[int], table: np.ndarray):
        self.stream = req.stream
        self.rid = req.rid
        self.pos_next = prompt_len      # next cache position to write
        self.last0 = first0             # last emitted token, 0-based
        self.remaining = req.max_new - 1
        self.step_idx = 0               # index into step_keys
        self.temperature = req.temperature
        self.eos0 = req.eos0
        self.step_keys = req.step_keys
        self.last_emit_at = time.perf_counter()
        self.blocks = blocks            # one pool ref per block
        self.table = table              # (M,) int32, scratch-padded
        # already-emitted 0-based tokens whose KV the decode step must
        # rebuild (a resume whose payload was lost): fed through decode
        # without being emitted again
        self.replay: deque = deque()
        # speculation state (spec engines only)
        self.draft_ok = False           # the drafter holds this slot
        self.demoted = False            # plain decode until re-probe
        self.accept_ema = None          # acceptance-rate EMA
        self.spec_rounds = 0            # rounds of EMA evidence
        self.probe_in = 0               # plain rounds until re-probe
        self.tree_rung = 0              # shape-ladder rung (tree mode)

    def key(self):
        """The chain key of the slot's next token (None when greedy)."""
        return (self.step_keys[self.step_idx]
                if self.step_keys is not None else None)


class KVHandoff:
    """One request between phase replicas.  The prefill replica builds
    it after emitting the first token; the coordinator fills
    ``payload`` (the exported wire arrays, or None to re-prefill on the
    decode side) and ``matched`` (blocks the decode pool's radix already
    held for this prompt, retained for the adoption, so only the
    unmatched tail travels); the decode replica takes it through
    :meth:`LMServingEngine.adopt`.  The sampling state (``step_keys``,
    the position, the last token) crosses intact."""

    __slots__ = ("stream", "prompt0", "max_new", "temperature", "eos0",
                 "step_keys", "rid", "first0", "payload", "matched",
                 "src_name")

    def __init__(self, req: _Request, first0: int, src_name: str):
        self.stream = req.stream
        self.prompt0 = req.prompt0
        self.max_new = req.max_new
        self.temperature = req.temperature
        self.eos0 = req.eos0
        self.step_keys = req.step_keys
        self.rid = req.rid
        self.first0 = int(first0)       # already emitted; never again
        self.payload = None             # {"k", "v", "blocks"} or None
        self.matched = []               # decode-pool blocks, retained
        self.src_name = src_name


class _Hibernated:
    """A stream swapped out of its decode slot into the host KV tier,
    with its full sampling state (``pos_next``, ``last0``,
    ``remaining``, ``step_idx``, ``step_keys``) so a resume re-enters
    decode at the exact token it left off.  The chain lives in the
    tier under ``("session", rid)`` until resume pops it into
    ``payload`` (kept across a pool-pressure deferral)."""

    __slots__ = ("stream", "rid", "pos_next", "last0", "remaining",
                 "step_idx", "temperature", "eos0", "step_keys",
                 "n_used", "payload", "fetched", "hibernated_at")

    def __init__(self, st: _Slot, n_used: int):
        self.stream = st.stream
        self.rid = st.rid
        self.pos_next = int(st.pos_next)
        self.last0 = int(st.last0)
        self.remaining = int(st.remaining)
        self.step_idx = int(st.step_idx)
        self.temperature = st.temperature
        self.eos0 = st.eos0
        self.step_keys = st.step_keys
        self.n_used = int(n_used)       # exported blocks (written KV)
        self.payload = None             # wire payload once fetched
        self.fetched = False            # the tier lookup happened
        self.hibernated_at = time.perf_counter()


class _Prefill:
    """An admitted request's prefill in progress (possibly chunk by
    chunk between decode rounds): blocks are allocated, ``p`` tokens are
    in the arena; ``logits`` (host) once the last chunk ran."""

    __slots__ = ("req", "blocks", "slot", "p", "t", "logits", "handoff")

    def __init__(self, req: _Request, blocks: List[int], slot: int,
                 matched_len: int, handoff: Optional[KVHandoff] = None):
        self.req = req
        self.blocks = blocks
        self.slot = slot
        self.p = matched_len
        self.t = req.prompt0.shape[0]
        self.logits = None
        self.handoff = handoff          # set: a re-prefill, no emit


# ---------------------------------------------------------------------- #
class LMServingEngine:
    """Serve ``TransformerLM`` generation, greedy or sampled, optionally
    speculative, with continuous batching over a paged, prefix-shared KV
    cache.

    Args:
        model: a ``TransformerLM`` with ``params`` set, on ``device``.
        slots: decode batch width S, the concurrent in-flight requests.
        cache_len: per-request context cap (default ``model.max_len``):
            every request needs ``prompt_len + max_new <= cache_len``.
        max_new_tokens: default generation budget per request.
        prefill_buckets: prompt-length pad buckets (default powers of
            two up to ``cache_len``); longer prompts prefill in
            block-aligned chunks of the largest.
        block_len: tokens per KV block (the page size).
        num_blocks: pool blocks including the scratch block (default:
            ``slots`` worst-case chains plus 4 for radix-held prefixes).
        enable_prefix_cache: radix prefix sharing on admission (never
            changes streamed tokens).
        temperature: default sampling temperature (0 is greedy); a
            request's ``submit(temperature=, rng=)`` overrides it.
        eos_id: default 1-based stop token; generation also stops at
            ``max_new``.
        max_queue: admission queue bound (``ServingQueueFull`` beyond).
        attention_impl: prefill attention: ``"flash"`` (the CUDA flash
            kernel at its default tile; its plain version on the CPU),
            ``"xla"`` (plain attention) or ``"auto"`` (the measured
            crossover per prefill bucket: on a CUDA device flash, at
            the tile a verdict of the autotune cache for the bucket's
            length on this device kind names, else the default tile; on
            the CPU the verdict's core, and plain without one); ``None``
            keeps the model's own rule.  Each bucket resolves once, here
            (``prefill_attention`` in ``stats()``).
        decode_attn: ``"paged_kernel"`` (the CUDA paged kernel; its
            plain version on the CPU), ``"gather"`` (dense gather of
            each chain) or ``"auto"`` (the kernel on a CUDA device,
            whatever the cache says; on the CPU the autotune cache's
            kernel-vs-gather verdict for (head_dim, block_len, dtype)
            on this device kind, and without one the gather, as the
            reference keeps it without evidence; always the gather with
            ``kv_quant``).  Greedy streams agree across all of them.
        kv_quant: ``None`` (float KV, the default) or ``"int8"``: int8
            arenas with per-(position, head) float32 scales, about 4x the
            positions in the same memory.  Lossy (streams are not
            bit-exact against a float pool); decodes through the gather,
            and ``decode_attn="paged_kernel"`` raises ``ValueError``.
        spec: a :class:`SpecConfig` (or an int k, ``SpecConfig(k=k)``)
            enabling draft-verify speculative decoding: every decode
            round becomes a verify round (plain slots ride it as one-row
            candidates).  Without ``draft`` the drafter is the target's
            int8 ``quantize()`` clone, running
            ``spec.drafter_compute`` (``"dequant"``, ``"int8"``,
            ``"auto"``); an int8 target drafts with its own weights
            (for a non-dequant mode, a clone sharing every int8 tensor
            with only the compute mode rewritten).
        max_cache_entries: LRU bound of each prefill cache (as the
            reference's ``CompileCache``).
        cuda_graphs: ``None`` (default) captures every device step as a
            CUDA graph on a CUDA device and runs eagerly on the CPU;
            ``False`` runs eagerly on the card too (to measure what
            capture returns); ``True`` off a CUDA device raises.
        kvtier: optional :class:`~bigdl_tpu_torch.serving.kvtier.\
HostBlockStore`, the host KV tier: radix-tail eviction demotes blocks
            into it (int8 pools with their scales), admission promotes a
            surviving continuation of a matched prefix back, and
            :meth:`hibernate` / :meth:`resume` swap whole streams out of
            their slots and back.
        honor_lifecycle: ``False`` records deadlines and cancels (and the
            decode slot-steps wasted on them) without acting on them.
        max_prefill_chunk_tokens: chunked-prefill interleave: the worker
            advances at most one block-aligned chunk of at most this
            many prompt tokens between decode rounds.  Needs a
            block-aligned prefill bucket (``ValueError`` otherwise).
            None (default) prefills each admission to completion.
        migrate: makes this engine a prefill replica: after a request's
            first token, ``migrate(handoff, blocks, pool)`` runs on the
            worker with the chain still referenced, and the request
            leaves this engine (see ``serving/disagg``).  Excludes
            ``spec`` and ``kv_quant``.
        metrics / metrics_prefix: a shared :class:`LMMetrics` (replicas
            of one phase or one set record into one) and the registry
            prefix it publishes under (default ``"serving/lm/"``).
        device: must be the model's device (default ``"cuda"``).
    """

    def __init__(self, model, *,
                 slots: int = 8,
                 cache_len: Optional[int] = None,
                 max_new_tokens: int = 32,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 block_len: int = 16,
                 num_blocks: Optional[int] = None,
                 enable_prefix_cache: bool = True,
                 temperature: float = 0.0,
                 eos_id: Optional[int] = None,
                 max_queue: int = 256,
                 attention_impl: Optional[str] = None,
                 decode_attn: str = "auto",
                 kv_quant: Optional[str] = None,
                 spec=None, kvtier=None, migrate=None, placement=None,
                 max_cache_entries: int = 16,
                 cuda_graphs: Optional[bool] = None,
                 honor_lifecycle: bool = True,
                 max_prefill_chunk_tokens: Optional[int] = None,
                 metrics: Optional[LMMetrics] = None,
                 metrics_prefix: str = "serving/lm/",
                 name: str = "lm",
                 device=None):
        if placement is not None:
            raise _not_ported("placement", "11.7")
        if isinstance(spec, int) and not isinstance(spec, bool):
            spec = SpecConfig(k=spec)
        if spec is not None and not isinstance(spec, SpecConfig):
            raise TypeError(f"spec must be a SpecConfig or an int, got "
                            f"{spec!r}")
        if migrate is not None and spec is not None:
            raise ValueError(
                "a prefill-phase replica (migrate=...) cannot speculate: "
                "it never decodes; speculation belongs on the decode "
                "replicas")
        if migrate is not None and kv_quant is not None:
            raise ValueError(
                "kv_quant='int8' excludes disaggregated serving: the "
                "handoff protocol carries full-precision wire payloads "
                "(the host KV tier, not the coordinator, is the "
                "quantized-chain migration path)")
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"engine on {self.device}, but the model lives "
                             f"on {model.device}")
        if model.params is None:
            raise ValueError("the model has no params: call model.build(seed) "
                             "or set model.params")
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda"
        elif cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs=True needs a CUDA device, the "
                             f"engine is on {self.device}")
        self.cuda_graphs = bool(cuda_graphs)
        self.model = model
        self.name = name
        self._params = model.params
        self.slots = int(slots)
        self.cache_len = int(cache_len or model.max_len)
        if self.cache_len > model.max_len:
            raise ValueError(
                f"cache_len ({self.cache_len}) exceeds model.max_len "
                f"({model.max_len})")
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self._max_queue = int(max_queue)

        if prefill_buckets is None:
            prefill_buckets = prefill_bucket_lengths(self.cache_len)
        self.prefill_buckets = tuple(sorted(set(
            int(b) for b in prefill_buckets)))
        if self.prefill_buckets[-1] > self.cache_len:
            raise ValueError(
                f"largest prefill bucket ({self.prefill_buckets[-1]}) "
                f"exceeds cache_len ({self.cache_len})")
        self.block_len = int(block_len)
        # padded block-table width: every request's chain fits in M ids
        self.table_width = -(-self.cache_len // self.block_len)
        # over-length prompts prefill in block-aligned chunks of the
        # largest bucket; 0 means buckets are sub-block (no chunking)
        self._chunk_full = (self.prefill_buckets[-1]
                            // self.block_len) * self.block_len
        self.migrate = migrate
        self.phase = "prefill" if migrate is not None else "colocated"
        self._chunk_cap = None
        if max_prefill_chunk_tokens is not None:
            if self._chunk_full == 0:
                raise ValueError(
                    "max_prefill_chunk_tokens needs at least one "
                    f"block-aligned prefill bucket (block_len "
                    f"{self.block_len}, largest bucket "
                    f"{self.prefill_buckets[-1]})")
            # chunk boundaries stay block-aligned so the suffix prefill's
            # prefix_len is a whole number of blocks
            self._chunk_cap = max(
                self.block_len,
                (int(max_prefill_chunk_tokens) // self.block_len)
                * self.block_len)
        if num_blocks is None:
            num_blocks = 1 + (self.slots + 4) * self.table_width
        mha = model._mha
        self.pool = BlockPool(n_layers=model.n_layers, n_heads=mha.n_head,
                              head_dim=mha.head_dim,
                              block_len=self.block_len,
                              num_blocks=num_blocks,
                              dtype=self._params["embed"].dtype,
                              device=self.device, kv_quant=kv_quant)
        self.kv_quant = self.pool.kv_quant
        self.radix = RadixCache(self.pool) if enable_prefix_cache else None
        self.radix_summary = None   # see attach_radix_summary
        self.kvtier = kvtier
        if kvtier is not None and self.radix is not None:
            # radix-tail eviction hands each victim block to the host
            # tier (with its scales when quantized) instead of dropping it
            self.radix.on_evict = self._demote_block
        self._prefix_block_buckets = prefill_bucket_lengths(
            self.table_width, min_bucket=1)

        self._prefill_attn = {b: self._prefill_plan(b, attention_impl)
                              for b in self.prefill_buckets}
        self.attention_impl = ("flash" if any(
            impl == "flash" for impl, _ in self._prefill_attn.values())
            else "xla")
        if decode_attn not in ("auto", "gather", "paged_kernel"):
            raise ValueError(f"decode_attn must be 'auto', 'gather' or "
                             f"'paged_kernel', got {decode_attn!r}")
        if self.kv_quant is not None:
            # the paged kernel reads raw float blocks: int8 arenas
            # dequantize inside the gather
            if decode_attn == "paged_kernel":
                raise ValueError(
                    "kv_quant='int8' requires decode_attn='gather' (the "
                    "paged kernel reads raw float blocks)")
            decode_attn = "gather"
        elif decode_attn == "auto" and self.device.type == "cuda":
            # the kernel wherever it runs: a verdict never moves the card
            # to the gather (flash_attention's rule)
            decode_attn = "paged_kernel"
        elif decode_attn == "auto":
            # on the CPU a tuned verdict for this device kind decides;
            # without one, the gather
            tuned = autotune.lookup_paged(mha.head_dim, self.block_len,
                                          self._params["embed"].dtype,
                                          device=self.device)
            decode_attn = ("paged_kernel" if tuned is not None
                           and tuned.use_kernel else "gather")
        self.decode_attn = decode_attn

        # -- the device steps, one graph per shape ---------------------- #
        self.graphs = GraphPool(self.device, capture=self.cuda_graphs)
        pool = self.pool

        def _prefill_fn(params, buffers, x):
            del buffers  # part of the CompileCache signature only
            impl, blocks = self._prefill_attn[x["ids"].shape[1]]
            logits, k, v = _prefill_parts(model, params, x["ids"],
                                          x["len"] - 1, attention_impl=impl,
                                          blocks=blocks)
            _insert_blocks(pool.k, pool.v, k, v, x["insert"], pool.ks,
                           pool.vs)
            return logits

        self.prefill_cache = CompileCache(
            _prefill_fn, graphs=self.graphs, max_entries=max_cache_entries,
            name=f"lm/{name}/prefill")

        def _prefix_prefill_fn(params, buffers, x):
            del buffers
            logits, k, v = _prefill_suffix_parts(
                model, params, x["ids"], x["len"] - 1, x["prefix_len"],
                x["blocks"], pool.k, pool.v, pool.ks, pool.vs)
            _insert_blocks(pool.k, pool.v, k, v, x["insert"], pool.ks,
                           pool.vs)
            return logits

        self.prefix_prefill_cache = CompileCache(
            _prefix_prefill_fn, graphs=self.graphs,
            max_entries=max_cache_entries, name=f"lm/{name}/prefix_prefill")

        def _decode_fn(x):
            return _decode_step_paged(
                model, self._params, x["token"], x["pos"], x["tables"],
                pool.k, pool.v, pool.ks, pool.vs, attn_impl=decode_attn)[0]

        self._decode_exec = StepGraph(_decode_fn, self.graphs,
                                      name=f"lm/{name}/decode",
                                      key=f"slots={self.slots}")

        # -- speculation (draft-verify) --------------------------------- #
        self.spec = spec
        self.draft = None
        self.spec_metrics = None
        if spec is not None:
            if spec.drafter_compute == "ngram":
                # zero-model prompt-lookup drafter: host-side suffix
                # matching, no device work, no arena
                self.draft = NgramDrafter(model.vocab_size, slots=self.slots,
                                          ngram_max=spec.ngram_max)
            else:
                draft_lm = spec.draft
                if draft_lm is None:
                    draft_lm = self._default_drafter(model,
                                                     spec.drafter_compute)
                if draft_lm.vocab_size != model.vocab_size:
                    raise ValueError(
                        f"draft model vocab ({draft_lm.vocab_size}) differs "
                        f"from the target's ({model.vocab_size}): drafted "
                        "token ids would not be the target's token ids")
                if draft_lm.device != self.device:
                    raise ValueError(f"draft model on {draft_lm.device}, "
                                     f"engine on {self.device}")
                self.draft = DraftModel(
                    draft_lm, slots=self.slots, cache_len=self.cache_len,
                    prefill_buckets=self.prefill_buckets,
                    max_cache_entries=max_cache_entries,
                    sampling=spec.sampling, graphs=self.graphs)
            self.spec_metrics = SpecMetrics().publish_to(get_registry())
            self.spec_metrics.compute_mode = self.draft.compute_mode
            if self.draft.compute_mode != "ngram":
                report = getattr(draft_lm, "quant_report", None) or {}
                self.spec_metrics.overflow_risk = float(
                    report.get("overflow_risk") or 0.0)
            self._verify_execs = self._verify_steps(spec)
            if spec.tree:
                # the accepted-path commit moves rows only for shapes
                # with off-spine nodes, up to the deepest alternate
                self._commit_dmax = max(
                    (s.max_depth for s in self._tree_shapes
                     if not s.is_chain), default=0)

                def _commit_fn(x):
                    _tree_commit_paged(x["src"], x["pos"], x["tables"],
                                       pool.k, pool.v, pool.ks, pool.vs)

                self._commit_exec = StepGraph(
                    _commit_fn, self.graphs, name=f"lm/{name}/commit",
                    key=f"dmax={self._commit_dmax}")

        reg = get_registry()
        self.metrics = (metrics if metrics is not None
                        else LMMetrics(self.slots)).publish_to(
            reg, prefix=metrics_prefix)
        self.metrics.spec = self.spec_metrics
        self._publish_kv_metrics(reg)
        self._ledger_keys = self._register_ledger()
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._adopt_q: deque = deque()       # KVHandoffs awaiting seats
        self._prefilling: deque = deque()    # chunk-interleaved _Prefills
        self.migrated = 0       # prefill phase: chains handed off
        self.adopted = 0        # decode phase: chains seated
        self.re_prefills = 0    # decode phase: lost payloads recomputed
        # the SLO controller's concurrency actuator: the decode step
        # always runs all S slots, admission fills at most this many
        self._slot_limit = self.slots
        self._free = list(range(self.slots))
        self._slots: List[Optional[_Slot]] = [None] * self.slots
        self._n_active = 0
        self._closing = False
        self._abort = False
        self._prefill_since_step = False     # splits the ITL histograms
        # -- hibernation (host KV tier) --------------------------------- #
        self._hibernate_req: set = set()     # rids awaiting swap-out
        self._hibernating: set = set()       # rids the worker is swapping
        self._seating: set = set()           # rids the worker is admitting
        self._hibernated: dict = {}          # rid -> _Hibernated
        self._resume_q: deque = deque()      # _Hibernated awaiting seats
        self.hibernations = 0   # streams swapped out to the host tier
        self.resumes = 0        # streams seated back from hibernation
        self.resume_re_prefills = 0  # lost payloads rebuilt by replay
        # -- request lifecycle (deadlines, cooperative cancel) ---------- #
        self.honor_lifecycle = bool(honor_lifecycle)
        self._lc_nudge = False    # a cancel or a deadline wants a sweep
        self._lc_lock = threading.Lock()
        self.lifecycle = {
            "expired_preadmission": 0,   # shed before prefill
            "expired_midstream": 0,      # truncated while decoding
            "cancelled": 0,              # cooperative cancels honored
            "wasted_decode_steps": 0,    # slot-steps past cancel/deadline
        }
        self._lc_counters = {k: reg.counter(f"serving/lifecycle/{k}")
                             for k in self.lifecycle}
        # the worker's own stream, ordered after everything the
        # constructing thread enqueued (the params, the zeroed arenas)
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._follow_caller()
        self._launches = {k.symbol: 0 for k in KERNELS}
        self._worker = threading.Thread(
            target=self._run, daemon=True, name=f"lm-serve-{name}")
        self._worker.start()
        self._register_flight()

    def _register_ledger(self) -> List[tuple]:
        """Attribute this engine's device bytes to the memory ledger: the
        KV arenas (and int8 scale arenas), the staged params, the
        drafter's dense arena and, with capture on, the graph pool the
        engine and its drafter share (its segments, once).  Rows and
        dtype names are the reference's; providers hold the engine's
        parts weakly; ``close`` releases the rows."""
        keys: List[tuple] = []
        try:
            from bigdl_tpu_torch.obs.ledger import get_ledger
            from bigdl_tpu_torch.quant.transform import params_nbytes
            led = get_ledger()
            name = self.name
            pool_ref = weakref.ref(self.pool)

            def _kv_bytes():
                p = pool_ref()
                return p.kv_arena_bytes if p is not None else None

            keys.append(led.register(
                "kvcache", f"{name}/kv_arena", _kv_bytes,
                shape=self.pool.shape, dtype=_dtype_name(self.pool.k.dtype)))
            if self.kv_quant is not None:
                def _scale_bytes():
                    p = pool_ref()
                    return p.scale_arena_bytes if p is not None else None

                keys.append(led.register(
                    "kvcache", f"{name}/scale_arena", _scale_bytes,
                    shape=self.pool.shape[:4], dtype="float32"))
            keys.append(led.register(
                "params", f"{name}/staged", params_nbytes(self._params),
                note=f"quant={params_dtype_tag(self._params)}"))
            if self.draft is not None and \
                    getattr(self.draft, "k", None) is not None:
                # (the n-gram drafter has no arena)
                draft_ref = weakref.ref(self.draft)

                def _draft_bytes():
                    d = draft_ref()
                    return d.arena_bytes if d is not None else None

                keys.append(led.register(
                    "spec", f"{name}/draft_arena", _draft_bytes,
                    shape=tuple(self.draft.k.shape),
                    dtype=_dtype_name(self.draft.k.dtype)))
            if self.graphs.capture:
                graphs_ref = weakref.ref(self.graphs)

                def _pool_bytes():
                    g = graphs_ref()
                    return g.pool_bytes() if g is not None else None

                keys.append(led.register(
                    "graphs", f"{name}/graph_pool", _pool_bytes,
                    note="CUDA-graph pool of the engine and its drafter"))
        except Exception:
            log.exception("memory-ledger registration failed")
        return keys

    def _register_flight(self) -> None:
        """Incident bundles carry this engine's ``stats()`` and its
        queued and seated request ids, under ``lm_engine/<name>``; both
        read host state only and hold the engine weakly.  Neither waits
        for the scheduler's lock, which ``warmup()`` holds through its
        captures: a dump on another engine's worker would stall that
        worker for the whole warmup.  A held lock reads as busy."""
        try:
            from bigdl_tpu_torch.obs import flight
            ref = weakref.ref(self)
            busy = "busy: the scheduler's lock is held (warmup or a round)"

            def _flight_state():
                eng = ref()
                if eng is None:
                    return None
                if not eng._cv.acquire(timeout=0.05):
                    return busy
                try:
                    return eng.stats()
                finally:
                    eng._cv.release()

            def _flight_requests():
                eng = ref()
                if eng is None:
                    return []
                if not eng._cv.acquire(timeout=0.05):
                    return [busy]
                try:
                    rids = [r.rid for r in eng._queue]
                    rids += [st.rid for st in eng._slots if st is not None]
                finally:
                    eng._cv.release()
                return rids

            flight.register_state(f"lm_engine/{self.name}", _flight_state)
            flight.register_requests(f"lm_engine/{self.name}",
                                     _flight_requests)
        except Exception:
            log.exception("flight-recorder registration failed")

    def _publish_kv_metrics(self, registry) -> None:
        """The KV plane's gauges.  Each reads host state only (the free
        list and the trie's counters), never a device tensor, and holds
        the engine weakly: the process-wide registry must not keep a
        closed engine's arenas alive."""
        ref = weakref.ref(self)

        def gauge(read, idle=None):
            def value():
                eng = ref()
                return read(eng) if eng is not None else idle
            return FnGauge(value)

        registry.register("kvcache/block_utilization",
                          gauge(lambda e: e.pool.utilization()),
                          replace=True)
        registry.register(
            "kvcache/prefix_hit_rate",
            gauge(lambda e: e.radix.hit_rate() if e.radix is not None
                  else None), replace=True)
        registry.register(
            "kvcache/prefill_tokens_saved",
            gauge(lambda e: e.radix.matched_tokens if e.radix is not None
                  else 0), replace=True)
        registry.register(
            "kvcache/evictions",
            gauge(lambda e: e.radix.evictions if e.radix is not None
                  else 0), replace=True)
        registry.gauge("kvcache/arena_bytes",
                       unit="bytes").set(self.pool.arena_bytes)

    @staticmethod
    def _default_drafter(model, compute: str):
        """The reference's default drafter: the target's int8 clone
        running ``compute``, or, for a target that is int8 already, the
        target itself (dequant) or a clone whose params share every int8
        tensor and differ in the compute mode only."""
        if params_dtype_tag(model.params) != "int8":
            return model.quantize("int8", compute=compute)
        if compute == "dequant":
            return model
        draft = copy.copy(model)
        draft.params = set_compute_mode(model.params, compute)
        return draft

    def _verify_steps(self, spec) -> List[StepGraph]:
        """The verify steps: one at (S, k+1), or one per tree rung, each
        rung's depths and ancestor matrix on the device once, here."""
        model, pool = self.model, self.pool
        if not spec.tree:
            def _verify_fn(x):
                return _verify_step_paged(
                    model, self._params, x["tokens"], x["pos"], x["ncand"],
                    x["tables"], pool.k, pool.v, pool.ks, pool.vs)[0]

            return [StepGraph(_verify_fn, self.graphs,
                              name=f"lm/{self.name}/verify",
                              key=f"k={spec.k}")]
        self._tree_shapes = list(spec.shapes)
        steps = []
        for shp in self._tree_shapes:
            depths = torch.as_tensor(np.asarray(shp.depths, np.int64),
                                     device=self.device)
            anc = torch.as_tensor(np.asarray(shp.anc, bool),
                                  device=self.device)

            def _tree_fn(x, depths=depths, anc=anc):
                return _tree_verify_step_paged(
                    model, self._params, x["tokens"], x["pos"], x["ncand"],
                    x["tables"], pool.k, pool.v, pool.ks, pool.vs,
                    depths=depths, anc=anc)[0]

            steps.append(StepGraph(_tree_fn, self.graphs,
                                   name=f"lm/{self.name}/verify",
                                   key=f"rung={len(steps)}"))
        return steps

    @property
    def _verify_compiles(self) -> int:
        """Verify entries made: 1 (linear) or one per tree rung."""
        if self.spec is None:
            return 0
        return sum(e.compiles for e in self._verify_execs)

    @property
    def _commit_compiles(self) -> int:
        """Tree-commit entries made: at most 1."""
        if self.spec is None or not self.spec.tree:
            return 0
        return self._commit_exec.compiles

    # ------------------------------------------------------------------ #
    def _before_traffic(self, what: str):
        # holding the scheduler's lock keeps the worker from admitting
        # anything while the arenas are touched here
        if (self._queue or self._n_active or self._adopt_q
                or self._prefilling):
            raise RuntimeError(f"{what} runs before traffic")

    def _follow_caller(self) -> None:
        """Order the worker's stream after the calling thread's current
        stream: work enqueued outside the worker (construction, warmup)
        lands before the worker's next launch."""
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def kernel_launches(self) -> dict:
        """Launches of each kernel (by C symbol) that this engine's
        worker made, through replays included; warmup, which runs on the
        caller's thread, is not counted."""
        return dict(self._launches)

    def warmup(self) -> int:
        """Make every prefill bucket's entry and the decode step (a spec
        engine: each verify width, the tree commit and the drafter's
        steps) before traffic, so no first use (a capture, the CUDA
        kernels' build and load, library kernel choices) is paid inside
        a request.  Each runs once; writes land only in scratch rows.
        Returns the number of prefill entries newly made."""
        with self._cv, torch.no_grad():
            self._before_traffic("warmup()")
            n = self.prefill_cache.warmup_inputs(
                self._params, self.model.buffers,
                [self._prefill_x(np.zeros((1, b), np.int64), b, 0, [])
                 for b in self.prefill_buckets])
            zeros = np.zeros((self.slots,), np.int32)
            tables = np.zeros((self.slots, self.table_width), np.int32)
            if self.migrate is not None:
                # a prefill replica never decodes: its requests migrate
                # after the first token
                self._follow_caller()
                return n
            if self.draft is None:
                self._decode(np.zeros((self.slots,), np.int64), zeros, tables)
                self._follow_caller()
                return n
            # a spec engine decodes through its verify steps only; idle
            # rows (n_cand 0) write the scratch block
            if self.spec.tree:
                for rung, shp in enumerate(self._tree_shapes):
                    self._verify(np.zeros((self.slots, shp.width), np.int32),
                                 zeros, zeros, tables, rung)
                if self._commit_dmax:
                    self._commit(np.tile(np.arange(
                        1, self._commit_dmax + 1, dtype=np.int32),
                        (self.slots, 1)), zeros, tables)
            else:
                self._verify(np.zeros((self.slots, self.spec.k + 1),
                                      np.int32), zeros, zeros, tables)
            self.draft.warmup()
            self._follow_caller()
        return n

    def warmup_prefix(self, suffix_lens: Optional[Sequence[int]] = None,
                      prefix_blocks: Optional[Sequence[int]] = None) -> int:
        """Make the prefix-suffix prefill entries before traffic: one per
        (suffix bucket, prefix-chain bucket) pair.  Optional (they are
        also made on first use), but a TTFT-sensitive deployment warms
        them so the first shared-prefix hit does not pay a capture.
        Pass the expected unmatched-suffix lengths and cached prefix
        block counts to warm only the pairs the traffic will hit (the
        full cross product otherwise).  Each runs once on scratch
        blocks.  Returns the number newly made."""
        if suffix_lens is not None:
            cap = self.prefill_buckets[-1]
            sb = sorted({self.bucket_for(min(int(s), cap))
                         for s in suffix_lens})
        else:
            sb = list(self.prefill_buckets)
        if prefix_blocks is not None:
            pbs = sorted({self._prefix_bucket_for(int(p))
                          for p in prefix_blocks})
        else:
            pbs = list(self._prefix_block_buckets)
        inputs = [self._prefill_x(np.zeros((1, b), np.int64), b,
                                  pb * self.block_len, [])
                  for b in sb for pb in pbs]
        with self._cv, torch.no_grad():
            self._before_traffic("warmup_prefix()")
            n = self.prefix_prefill_cache.warmup_inputs(
                self._params, self.model.buffers, inputs)
            self._follow_caller()
            return n

    def _prefill_plan(self, length: int, attention_impl):
        """The prefill core of one bucket length, ``("flash", (block_q,
        block_k))`` or ``("xla", None)``, resolved at construction for
        every bucket: a verdict for one length never routes another, and
        no lookup runs on a serving step."""
        mha = self.model._mha
        dt = self._params["embed"].dtype
        if not mha.resolve_use_flash(self.device, attention_impl,
                                     seq_len=length, dtype=dt):
            return ("xla", None)
        pinned = mha.pinned_tile(dt, attention_impl)
        if pinned is not None:
            return ("flash", pinned)
        plan = resolve_attention_plan(length, mha.head_dim, dt, True,
                                      device=self.device)
        return (("xla", None) if plan.impl == "xla"
                else ("flash", (plan.block_q, plan.block_k)))

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest configured prefill bucket >= prompt_len."""
        for b in self.prefill_buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest prefill "
            f"bucket ({self.prefill_buckets[-1]}) and the buckets are "
            f"smaller than one KV block ({self.block_len}): chunked "
            "prefill needs at least one block-aligned bucket")

    def _prefix_bucket_for(self, n_blocks: int) -> int:
        for pb in self._prefix_block_buckets:
            if pb >= n_blocks:
                return pb
        return self._prefix_block_buckets[-1]

    def submit(self, prompt_ids, *,
               max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               rng=None) -> LMStream:
        """Enqueue one prompt ((t,) or (1, t), 1-based ids); returns an
        :class:`LMStream` of its continuation.  A sampled request
        (``temperature > 0``) draws from the key chain of ``rng`` (an int
        seed or a (2,) uint32 key, default seed 0), exactly as offline
        ``generate`` at batch 1 does.

        ``deadline_s`` is a wall-clock budget armed here: a budget of 0
        or less raises :class:`ServingDeadlineExceeded` at once; a
        request still queued when it runs out is shed with that error
        before any prefill; a stream past it mid-decode is finished with
        a :class:`StreamTruncation` and its slot and blocks recycled in
        the same scheduler round."""
        prompt = np.asarray(prompt_ids).reshape(-1).astype(np.int32)
        t = prompt.shape[0]
        if t == 0:
            raise ValueError("empty prompt")
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.max_new_tokens)
        if max_new <= 0:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        if t + max_new > self.cache_len:
            raise ValueError(
                f"prompt ({t}) + max_new ({max_new}) exceeds cache_len "
                f"({self.cache_len})")
        need = self.pool.blocks_for(t + max_new)
        if need > self.pool.capacity:
            self.metrics.record_reject()
            count_rejection()
            raise RequestExceedsPool(
                f"request needs {need} KV blocks ({t} prompt + {max_new} "
                f"new tokens at block_len {self.block_len}); the whole "
                f"pool holds {self.pool.capacity}")
        if self._chunk_full == 0:
            self.bucket_for(t)  # sub-block buckets: no chunked prefill
        temp = float(self.temperature if temperature is None
                     else temperature)
        eos = eos_id if eos_id is not None else self.eos_id
        eos0 = (int(eos) - 1) if eos is not None else None
        first_key = step_keys = None
        if temp > 0.0:
            # offline generate()'s key chain: one split for the first
            # token, then max_new - 1 step keys
            key, first_key = keychain.split(keychain.as_key(rng))
            if max_new > 1:
                step_keys = keychain.split(key, max_new - 1)
        # the admission fault site: an injected transient is the typed shed
        try:
            fault_point("serving.enqueue", name=self.name, n=t)
        except ServingOverloaded:
            raise
        except TransientBackendError as e:
            self.metrics.record_reject()
            count_rejection()
            raise ServingOverloaded(
                f"admission shed (injected at serving.enqueue): {e}") from e
        rid = mint_request_id()
        stream = LMStream(prompt, max_new, request_id=rid,
                          deadline_s=deadline_s)
        stream._wake_cb = self._lc_wake
        if (self.honor_lifecycle and deadline_s is not None
                and float(deadline_s) <= 0.0):
            # dead on arrival: shed at once, typed
            self.metrics.record_reject()
            count_rejection()
            self._lc_count("expired_preadmission")
            raise ServingDeadlineExceeded(
                f"deadline_s={deadline_s} already expired at enqueue")
        req = _Request(stream, prompt - 1, max_new, temp, eos0, first_key,
                       step_keys, rid)
        with self._cv:
            if self._closing:
                raise ServingClosed("LMServingEngine is closed")
            if len(self._queue) >= self._max_queue:
                self.metrics.record_reject()
                count_rejection()
                raise ServingQueueFull(
                    f"admission queue full ({self._max_queue})")
            self._queue.append(req)
            depth = len(self._queue)
            self._cv.notify_all()
        self.metrics.record_submit()
        if _tracer.sampled(rid):
            _tracer.instant("lm/enqueue", cat="serve", request_id=rid,
                            prompt_len=t, max_new=max_new,
                            queue_depth=depth)
        return stream

    def generate(self, prompt_ids, *, timeout: Optional[float] = None,
                 **kw) -> np.ndarray:
        """Sync convenience: submit + wait; returns (t + generated,)
        1-based ids for one prompt."""
        return self.submit(prompt_ids, **kw).result(timeout=timeout)

    def adopt(self, handoff: KVHandoff) -> None:
        """Accept a migrated request (the decode phase's entry point):
        the worker seats the handoff's chain (the wire payload plus the
        blocks the local radix already held) into a slot and decodes on
        from the token the prefill replica emitted.  Adoptions rank
        ahead of queued submissions and defer under pool pressure like
        them."""
        # a cancel now has to wake THIS worker
        handoff.stream._wake_cb = self._lc_wake
        with self._cv:
            if self._closing:
                raise ServingClosed("LMServingEngine is closed")
            self._adopt_q.append(handoff)
            self._cv.notify_all()
        self.metrics.record_submit()
        if _tracer.sampled(handoff.rid):
            _tracer.instant("lm/adopt_enqueue", cat="serve",
                            request_id=handoff.rid, src=handoff.src_name,
                            wire_blocks=(handoff.payload["blocks"]
                                         if handoff.payload else None),
                            matched_blocks=len(handoff.matched))

    # -- live control knobs (the SLO controller's actuators) ----------- #
    def set_slot_limit(self, n: int) -> int:
        """Cap decode concurrency at ``n`` of the S slots (clamped to
        [1, slots]); the decode step keeps its shape, only admission
        stops filling slots past the cap.  Returns the applied value."""
        with self._cv:
            self._slot_limit = max(1, min(int(n), self.slots))
            self._cv.notify_all()
            return self._slot_limit

    @property
    def slot_limit(self) -> int:
        with self._cv:
            return self._slot_limit

    def set_max_queue(self, n: int) -> None:
        """Rebind the admission queue bound live (new arrivals past it
        get ``ServingQueueFull``; queued requests stay)."""
        with self._cv:
            self._max_queue = max(0, int(n))

    @property
    def max_queue(self) -> int:
        with self._cv:
            return self._max_queue

    def attach_radix_summary(self, summary) -> None:
        """Publish this engine's radix trie to a router: ``summary``
        mirrors the trie's prefix fingerprints through the per-node
        hooks (see ``serving/router/summary.py``)."""
        if self.radix is None:
            raise ValueError(
                "attach_radix_summary requires enable_prefix_cache=True")
        self.radix.attach_summary(summary)
        self.radix_summary = summary

    # -- worker -------------------------------------------------------- #
    def _run(self):
        try:
            tally_launches(self._launches)
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
                # every launch, copy and replay of this worker
                torch.cuda.set_stream(self._stream)
            with torch.no_grad():  # grad mode is per thread
                self._loop()
        except Exception as e:  # noqa: BLE001 - the worker's boundary:
            # every waiting client gets the error instead of hanging
            self._fail_all(e)
            return
        finally:
            if self._stream is not None:
                # nothing of this engine's stays in flight past its worker
                self._stream.synchronize()
        self._fail_all(ServingClosed("engine closed before completion"))

    def _loop(self):
        while True:
            with self._cv:
                while (not self._queue and not self._adopt_q
                       and not self._resume_q and not self._n_active
                       and not self._prefilling and not self._hibernate_req
                       and not self._closing and not self._abort
                       and not self._lc_nudge):
                    if not self._cv.wait(self._lc_wait_timeout()):
                        # a holding station's deadline came due while
                        # the engine idled (a hibernated stream, say)
                        self._lc_nudge = True
                if self._abort:
                    return
                if (self._closing and not self._queue and not self._adopt_q
                        and not self._resume_q and not self._n_active
                        and not self._prefilling):
                    # the caller's _fail_all resolves streams still
                    # hibernated with ServingClosed
                    return
                # cancelled or expired requests leave their holding
                # stations before this round admits anything
                self._lifecycle_sweep_locked()
                # in flight = decoding + mid-prefill: both hold slots
                inflight = self._n_active + len(self._prefilling)

                def take(q, taken):
                    out = []
                    while (self._free and q
                           and inflight + taken + len(out)
                           < self._slot_limit):
                        out.append((self._free.pop(), q.popleft()))
                    return out

                # adoptions and resumes rank ahead of fresh admissions
                # (their first token is paid), adoptions first
                adopts = take(self._adopt_q, 0)
                resumes = take(self._resume_q, len(adopts))
                admits = take(self._queue, len(adopts) + len(resumes))
            if self.migrate is not None:
                # a prefill replica's occupancy, one sample a round (it
                # has no decode steps)
                self.metrics.record_step(
                    min(self.slots, inflight + len(adopts) + len(admits)),
                    [])
            deferred = [], [], []
            for (seat, items), out in zip(
                    ((self._adopt_into, adopts), (self._resume_into, resumes),
                     (self._admit, admits)), deferred):
                for slot, item in items:
                    try:
                        seated = seat(slot, item)
                    except Exception as e:  # noqa: BLE001 - fail this one
                        item.stream._finish(error=e)
                        with self._cv:
                            self._free.append(slot)
                    else:
                        if not seated:
                            out.append((slot, item))
            if any(deferred):
                # pool pressure: requeue at the FRONT (FIFO order kept)
                # and return the slots; blocks free as streams finish
                with self._cv:
                    for q, items in zip((self._adopt_q, self._resume_q,
                                         self._queue), deferred):
                        for slot, item in reversed(items):
                            self._free.append(slot)
                            q.appendleft(item)
                    if not self._n_active and not self._prefilling:
                        self._cv.wait(0.05)
            self._lifecycle_round()
            if self._hibernate_req:
                self._service_hibernations()
            if self._prefilling:
                # the interleave: ONE chunk of the oldest prefill in
                # progress a round, then back to decoding
                pf = self._prefilling[0]
                try:
                    if self._prefill_chunk(pf):
                        self._prefilling.popleft()
                        self._complete_prefill(pf)
                except Exception as e:  # noqa: BLE001 - fail this one
                    if self._prefilling and self._prefilling[0] is pf:
                        self._prefilling.popleft()
                    self.pool.release(pf.blocks)
                    pf.req.stream._finish(error=e)
                    with self._cv:
                        self._free.append(pf.slot)
            if self._n_active:
                if self.draft is None:
                    self._step()
                elif self.spec.tree:
                    self._step_spec_tree()
                else:
                    self._step_spec()

    # -- request lifecycle (deadlines, cooperative cancel) -------------- #
    def _lc_wake(self):
        """``LMStream._wake_cb``: a cancel wakes an idle worker so it is
        honored at the next scheduler round."""
        with self._cv:
            self._lc_nudge = True
            self._cv.notify_all()

    def _lc_count(self, key: str, n: int = 1) -> None:
        if n <= 0:
            return
        with self._lc_lock:
            self.lifecycle[key] += n
        self._lc_counters[key].add(n)

    def _lc_wait_timeout(self) -> Optional[float]:
        """The earliest pending deadline among the slot-less holding
        stations (queued, resuming, hibernated), as a wait bound: an
        idle engine must still wake to shed an expiring hibernated
        stream.  Caller holds ``_cv``; None when no deadline is
        pending."""
        if not self.honor_lifecycle:
            return None
        dls = [r.stream.deadline_at for r in self._queue]
        dls += [h.stream.deadline_at for h in self._adopt_q]
        dls += [h.stream.deadline_at for h in self._resume_q]
        dls += [h.stream.deadline_at for h in self._hibernated.values()]
        dls = [d for d in dls if d is not None]
        if not dls:
            return None
        return max(0.0, min(dls) - time.monotonic()) + 0.005

    def _lc_shed_queued(self, stream: LMStream, rid) -> None:
        """A queued, never-prefilled request left: a cancel truncates
        quietly; a blown deadline is the typed pre-admission shed,
        counted like an admission-control rejection."""
        if stream.cancel_requested:
            reason = "cancelled"
            self._lc_count("cancelled")
            stream._finish_truncated("cancelled")
        else:
            reason = "deadline"
            self.metrics.record_reject()
            count_rejection()
            self._lc_count("expired_preadmission")
            stream._finish(error=ServingDeadlineExceeded(
                f"deadline ({stream.deadline_s}s) expired before "
                "prefill; request shed pre-admission"))
        if _tracer.sampled(rid):
            _tracer.instant("lm/lifecycle_shed", cat="serve",
                            request_id=rid, reason=reason, station="queue")

    def _lc_truncate(self, stream: LMStream, rid, *,
                     station: str = "seated") -> None:
        """Finish a request that got past admission with the truncation
        marker; the tokens already emitted stay valid."""
        if stream.cancel_requested:
            reason = "cancelled"
            self._lc_count("cancelled")
        else:
            reason = "deadline"
            self._lc_count("expired_midstream")
        stream._finish_truncated(reason)
        self.metrics.record_complete()
        if _tracer.sampled(rid):
            _tracer.instant("lm/lifecycle_truncate", cat="serve",
                            request_id=rid, reason=reason, station=station,
                            at_tokens=len(stream.generated))

    def _lifecycle_sweep_locked(self) -> None:
        """Shed cancelled or expired requests from every station that
        holds no decode slot: the admission queue (before prefill), the
        adoption queue, the resume queue and the hibernated set (a
        hibernated stream is
        cancellable without a resume: its chain drops out of the host
        tier, no transfer).  Caller holds ``_cv``."""
        self._lc_nudge = False
        if not self.honor_lifecycle:
            return
        now = time.monotonic()
        if any(r.stream.dead(now) for r in self._queue):
            live = []
            while self._queue:
                r = self._queue.popleft()
                if r.stream.dead(now):
                    self._lc_shed_queued(r.stream, r.rid)
                else:
                    live.append(r)
            self._queue.extend(live)
        if any(h.stream.dead(now) for h in self._adopt_q):
            live = []
            while self._adopt_q:
                h = self._adopt_q.popleft()
                if h.stream.dead(now):
                    # its retained decode-pool blocks go back
                    if h.matched:
                        self.pool.release(h.matched)
                    self._lc_truncate(h.stream, h.rid, station="adopt_q")
                else:
                    live.append(h)
            self._adopt_q.extend(live)
        if any(h.stream.dead(now) for h in self._resume_q):
            live = []
            while self._resume_q:
                hib = self._resume_q.popleft()
                if hib.stream.dead(now):
                    # a fetched payload rides the handle: dropping the
                    # handle drops the chain
                    self._lc_truncate(hib.stream, hib.rid,
                                      station="resume_q")
                else:
                    live.append(hib)
            self._resume_q.extend(live)
        for rid in [rid for rid, hib in self._hibernated.items()
                    if hib.stream.dead(now)]:
            hib = self._hibernated.pop(rid)
            if self.kvtier is not None:
                self.kvtier.get(("session", rid), pop=True)
            self._lc_truncate(hib.stream, rid, station="hibernated")

    def _lifecycle_round(self) -> None:
        """The per-round pass over seated (and mid-prefill) streams, at a
        round boundary (never inside a step).  The ``serving.cancel`` fault site is
        crossed once per seated stream, and a fault there IS that client
        disconnecting; then cancelled or expired streams are retired
        like a finished one (slot freed, blocks released, drafter state
        dropped) and finished with the truncation marker.  With
        ``honor_lifecycle=False`` nothing is freed: every dead seated
        stream counts one wasted decode slot-step per round."""
        with self._cv:
            seated = [st.stream for st in self._slots if st is not None]
            seated += [pf.req.stream for pf in self._prefilling]
        for s in seated:
            try:
                fault_point("serving.cancel", name=self.name,
                            rid=s.request_id)
            except (TransientBackendError, BackendLostError):
                s.cancel()
        now = time.monotonic()
        if not self.honor_lifecycle:
            with self._cv:
                n_dead = sum(1 for st in self._slots
                             if st is not None and st.stream.dead(now))
            self._lc_count("wasted_decode_steps", n_dead)
            return
        with self._cv:
            if any(pf.req.stream.dead(now) for pf in self._prefilling):
                live = []
                while self._prefilling:
                    pf = self._prefilling.popleft()
                    if pf.req.stream.dead(now):
                        self.pool.release(pf.blocks)
                        self._free.append(pf.slot)
                        self._lc_truncate(pf.req.stream, pf.req.rid,
                                          station="prefilling")
                    else:
                        live.append(pf)
                self._prefilling.extend(live)
            freed = False
            for i, st in enumerate(self._slots):
                if st is None or not st.stream.dead(now):
                    continue
                s = st.stream
                if s.cancel_requested:
                    # decode steps between the cancel landing and this
                    # round were wasted
                    self._lc_count(
                        "wasted_decode_steps",
                        max(0, len(s._tokens) - s._cancel_at_gen))
                self._trace_done(s, st.rid)
                self.pool.release(st.blocks)
                self._slots[i] = None
                if self.draft is not None:
                    self.draft.release(i)
                self._free.append(i)
                self._n_active -= 1
                self._lc_truncate(s, st.rid)
                freed = True
            if freed:
                self._cv.notify_all()

    def _mem_pressure_deferred(self) -> bool:
        """The byte-level admission gate: past the memory ledger's
        watermark, defer the admission exactly like pool pressure, and
        let the ledger dump ONE ``mem_pressure`` bundle while the
        attribution table can still be written."""
        try:
            from bigdl_tpu_torch.obs.ledger import get_ledger
            led = get_ledger()
            if led.over_watermark(self.device):
                led.check_pressure(
                    self.device,
                    context={"site": f"lm_admission/{self.name}"})
                return True
        except Exception:
            pass
        return False

    def _admit(self, slot: int, req: _Request) -> bool:
        """Prefill + insert one request into ``slot``.  Returns False
        (defer) when the pool can't supply its blocks right now, even
        after evicting unreferenced radix tails, or when the memory
        ledger reads the device past its watermark."""
        if self._mem_pressure_deferred():
            return False
        t = req.prompt0.shape[0]
        need_total = self.pool.blocks_for(t + req.max_new)
        matched: List[int] = []
        if self.radix is not None:
            matched = self.radix.match(req.prompt0)  # retains for us
            if self.kvtier is not None:
                # a prefix that fell out of the arenas may survive in the
                # host tier: promote its continuation, prefill past it
                matched = self._promote_extend(req.prompt0, matched,
                                               rid=req.rid)
        traced = _tracer.sampled(req.rid)
        if traced and self.radix is not None:
            _tracer.instant("lm/radix_match", cat="serve",
                            request_id=req.rid, matched_blocks=len(matched),
                            matched_tokens=len(matched) * self.block_len,
                            prompt_len=t)
        fresh = self._alloc_or_evict(need_total - len(matched))
        if fresh is None:
            if matched:
                self.pool.release(matched)
            return False
        blocks = matched + fresh
        if traced:
            # the queue wait is known only now, at admission
            _tracer.add_complete("lm/queue_wait", req.stream.submitted_at,
                                 time.perf_counter()
                                 - req.stream.submitted_at, cat="serve",
                                 args={"request_id": req.rid, "slot": slot})
        pf = _Prefill(req, blocks, slot, len(matched) * self.block_len)
        self._run_prefill(pf)
        return True

    def _run_prefill(self, pf: _Prefill) -> None:
        """An admitted prefill: queued for the interleave (one chunk a
        round, see ``_loop``) under a chunk cap, else run to completion
        here; on failure its blocks are released."""
        if self._chunk_cap is not None:
            self._prefilling.append(pf)
            return
        try:
            while not self._prefill_chunk(pf):
                pass
            self._complete_prefill(pf)
        except BaseException:
            self.pool.release(pf.blocks)
            raise

    def _complete_prefill(self, pf: _Prefill) -> None:
        """Finish a prefill whose prompt is all in the arena.  The first
        token is streamed before the slot is seated (a spec engine admits
        the drafter in between): a hibernate asked for in that window
        waits for the seat."""
        with self._cv:
            self._seating.add(pf.req.rid)
        try:
            self._finish_prefill(pf)
        finally:
            with self._cv:
                self._seating.discard(pf.req.rid)

    def _prefill_x(self, ids: np.ndarray, ts: int, p: int,
                   blocks: Sequence[int]) -> dict:
        """A prefill entry's inputs for the ``ts`` tokens in ``ids`` (1,
        bucket) at position ``p`` of a chain ``blocks``: the block ids
        the chunk's k/v rows scatter into (block-aligned; bucket-padding
        rows land in trailing owned blocks or the scratch block, always
        masked until overwritten) and, past the first chunk, the
        scratch-padded prefix chain."""
        B = self.block_len
        nb_w = -(-ids.shape[1] // B)
        ids_w = np.zeros((nb_w,), np.int64)
        owned = blocks[p // B:p // B + nb_w]
        ids_w[:len(owned)] = owned
        x = {"ids": ids, "len": np.int32(ts), "insert": ids_w}
        if p:
            nbp = p // B
            chain = blocks[:nbp]        # empty in warmup: scratch only
            pblocks = np.zeros((self._prefix_bucket_for(nbp),), np.int64)
            pblocks[:len(chain)] = chain
            x.update(prefix_len=np.int32(p), blocks=pblocks)
        return x

    def _prefill_chunk(self, pf: _Prefill) -> bool:
        """One bucketed prefill pass + block scatter; True when the
        whole prompt is in the arena.  Chunks stay block-aligned (except
        the final remainder) so the suffix path's prefix_len is always a
        whole number of blocks."""
        req, t, p = pf.req, pf.t, pf.p
        largest, chunk_full = self.prefill_buckets[-1], self._chunk_full
        if self._chunk_cap is not None:
            # the cap only lowers the per-chunk ceiling
            largest = min(largest, self._chunk_cap)
            chunk_full = min(chunk_full, self._chunk_cap)
        rem = t - p
        ts = rem if rem <= largest else chunk_full
        ids = np.zeros((1, self.bucket_for(ts)), np.int64)
        ids[0, :ts] = req.prompt0[p:p + ts]
        x = self._prefill_x(ids, ts, p, pf.blocks)
        cache = self.prefill_cache if p == 0 else self.prefix_prefill_cache
        rid_args = ({"request_id": req.rid}
                    if _tracer.sampled(req.rid) else {})
        with _tracer.span("lm/prefill", cat="serve", bucket=ids.shape[1],
                          prompt_len=t, prefix_len=p, **rid_args):
            logits = cache(self._params, self.model.buffers, x)
        self._prefill_since_step = True
        pf.p = p + ts
        if pf.p >= t:
            # only the last chunk's logits are read, before any other
            # step replays over them
            pf.logits = logits.cpu().numpy()  # synchronises; (1, V)
        return pf.p >= t

    def _finish_prefill(self, pf: _Prefill) -> None:
        req, blocks, slot, t = pf.req, pf.blocks, pf.slot, pf.t
        B = self.block_len
        # cache the prompt's full blocks for future prefix hits (the
        # matched head is already in the trie; only novel tails add)
        if self.radix is not None and t // B:
            self.radix.insert(req.prompt0[:(t // B) * B], blocks[:t // B])
        if pf.handoff is not None:
            # the re-prefill of a migrated request whose payload was
            # lost: the first token was emitted on the prefill replica;
            # the rows are rebuilt and the logits dropped
            self._seat(req, t, pf.handoff.first0, blocks, slot)
            return
        first0 = pick_token(pf.logits[0], req.temperature, req.first_key,
                            clamp=False)
        req.stream._emit(first0 + 1)
        self.metrics.record_first_token(
            req.stream.first_token_at - req.stream.submitted_at)
        if req.max_new == 1 or (req.eos0 is not None
                                and first0 == req.eos0):
            req.stream._finish()
            self.metrics.record_complete()
            self._trace_done(req.stream, req.rid)
            self.pool.release(blocks)
            with self._cv:
                self._free.append(slot)
            return
        if self.migrate is not None:
            # a prefill replica: the chain and the sampling state hop to
            # a decode replica; the slot and blocks free once the
            # callback returns (it runs with the references held)
            h = KVHandoff(req, first0, self.name)
            rid_args = ({"request_id": req.rid}
                        if _tracer.sampled(req.rid) else {})
            try:
                with _tracer.span("lm/migrate", cat="serve", prompt_len=t,
                                  **rid_args):
                    self.migrate(h, blocks, self.pool)
                self.migrated += 1
            except Exception as e:  # noqa: BLE001 - fail this request
                req.stream._finish(error=e)
                self._trace_done(req.stream, req.rid)
            finally:
                self.pool.release(blocks)
                with self._cv:
                    self._free.append(slot)
            return
        self._seat(req, t, first0, blocks, slot)

    def _seat(self, req: _Request, t: int, first0: int, blocks: List[int],
              slot: int) -> None:
        """Seat a request whose prompt is in the arena and whose first
        token ``first0`` is emitted into its decode slot."""
        table = np.zeros((self.table_width,), np.int32)
        table[:len(blocks)] = blocks
        st = _Slot(req, t, first0, blocks, table)
        if self.draft is not None:
            # the drafter prefills the whole prompt into its own cache,
            # the first token queued as pending; a prompt admitted in
            # chunks serves plain decode
            st.draft_ok = self.draft.can_draft(t)
            if st.draft_ok:
                self.draft.admit(slot, req.prompt0)
                self.draft.push(slot, first0)
                if self.spec.tree:
                    st.tree_rung = self.spec.init_rung
        with self._cv:
            self._slots[slot] = st
            self._n_active += 1

    def _adopt_into(self, slot: int, h: KVHandoff) -> bool:
        """Seat a migrated request into ``slot``: adopt its wire payload
        into this pool (or re-prefill the prompt when the payload was
        lost) and enter decode where the prefill replica left off.
        False (defer) under pool pressure; the handoff's retained
        ``matched`` blocks stay held across a deferral."""
        t = h.prompt0.shape[0]
        B = self.block_len
        need_total = self.pool.blocks_for(t + h.max_new)
        matched = list(h.matched)
        if need_total > self.pool.capacity:
            if matched:
                self.pool.release(matched)
            raise RequestExceedsPool(
                f"migrated request needs {need_total} blocks; the decode "
                f"pool holds {self.pool.capacity}")
        req = _Request(h.stream, h.prompt0, h.max_new, h.temperature,
                       h.eos0, None, h.step_keys, h.rid)
        if h.payload is None:
            # the payload was lost in transit: recompute the rows here
            # (deterministic prefill, bitwise the same); the first token
            # rides the handoff and is never picked or emitted again
            fresh = self._alloc_or_evict(need_total - len(matched))
            if fresh is None:
                return False
            self.re_prefills += 1
            self._run_prefill(_Prefill(req, matched + fresh, slot,
                                       len(matched) * B, handoff=h))
            return True
        n_wire = int(h.payload["blocks"])
        extra = need_total - len(matched) - n_wire
        if extra < 0:
            if matched:
                self.pool.release(matched)
            raise ValueError(f"wire carries {n_wire} blocks but only "
                             f"{need_total - len(matched)} are unmatched")
        try:
            fresh = self._alloc_or_evict(
                n_wire + extra, lambda: self.pool.adopt_chain(
                    h.payload["k"], h.payload["v"], extra_blocks=extra))
        except BaseException:
            if matched:
                self.pool.release(matched)
            raise
        if fresh is None:
            return False
        blocks = matched + fresh
        self.adopted += 1
        self._prefill_since_step = True   # an adoption interrupts decode
        if self.radix is not None and t // B:
            # future prefix hits on THIS pool share the adopted chain
            self.radix.insert(h.prompt0[:(t // B) * B], blocks[:t // B])
        if _tracer.sampled(h.rid):
            _tracer.instant("lm/adopt", cat="serve", request_id=h.rid,
                            slot=slot, wire_blocks=n_wire,
                            matched_blocks=len(matched), src=h.src_name)
        self._seat(req, t, h.first0, blocks, slot)
        return True

    # -- decode rounds ------------------------------------------------- #
    def _emit(self, st: _Slot, token0: int, now: float, itls: list) -> bool:
        """Stream one token from a slot and book it; True when the stream
        is done (budget spent or EOS), which finishes it."""
        st.stream._emit(token0 + 1)
        itls.append(now - st.last_emit_at)
        st.last_emit_at = now
        st.last0 = token0
        st.pos_next += 1
        st.step_idx += 1
        st.remaining -= 1
        if st.remaining <= 0 or (st.eos0 is not None and token0 == st.eos0):
            st.stream._finish()
            self.metrics.record_complete()
            return True
        return False

    @staticmethod
    def _replay_one(st: _Slot) -> None:
        """A resumed slot whose payload was lost: this step rebuilt
        ``last0``'s k/v row; the next token was emitted before the
        hibernation, so it comes from the replay queue instead of the
        logits (no emit, no ITL sample; the key chain stays aligned)."""
        st.last0 = st.replay.popleft()
        st.pos_next += 1
        st.step_idx += 1
        st.remaining -= 1

    def _record_step(self, n_active: int, itls: list) -> None:
        self.metrics.record_step(n_active, itls,
                                 prefill_interrupted=self._prefill_since_step)
        self._prefill_since_step = False

    def _trace_rounds(self, name: str, active, t0: float, now: float,
                      **extra) -> None:
        """One retroactive span per sampled slot of a batched step."""
        if not _tracer.enabled:
            return
        for i in active:
            st = self._slots[i]
            if _tracer.sampled(st.rid):
                args = {"request_id": st.rid, "slot": i,
                        "step": st.step_idx}
                args.update({k: v(i) for k, v in extra.items()})
                _tracer.add_complete(name, t0, now - t0, cat="serve",
                                     args=args)

    @staticmethod
    def _trace_done(stream: LMStream, rid: Optional[str]) -> None:
        """The request's root span (submit to finish), recorded when its
        extent is known."""
        if not _tracer.sampled(rid):
            return
        end = stream.finished_at
        if end is None:
            end = time.perf_counter()
        _tracer.add_complete(
            "lm/request", stream.submitted_at, end - stream.submitted_at,
            cat="serve",
            args={"request_id": rid, "prompt_len": int(len(stream.prompt)),
                  "max_new": stream.max_new,
                  "emitted": len(stream.generated)})

    def _retire(self, freed: List[int]) -> None:
        """Return finished slots and their blocks."""
        if not freed:
            return
        with self._cv:
            for i in freed:
                self._trace_done(self._slots[i].stream, self._slots[i].rid)
                self.pool.release(self._slots[i].blocks)
                self._slots[i] = None
                if self.draft is not None:
                    self.draft.release(i)
                self._free.append(i)
                self._n_active -= 1
            self._cv.notify_all()

    def _step(self):
        token = np.zeros((self.slots,), np.int64)
        pos = np.zeros((self.slots,), np.int32)
        tables = np.zeros((self.slots, self.table_width), np.int32)
        active = []
        for i, st in enumerate(self._slots):
            if st is not None:
                active.append(i)
                token[i] = st.last0
                pos[i] = st.pos_next
                tables[i] = st.table
        if not active:
            return
        t0 = time.perf_counter()
        with _tracer.span("lm/decode_step", cat="serve", active=len(active)):
            logits = self._decode(token, pos, tables)
        now = time.perf_counter()
        self._trace_rounds("lm/decode_round", active, t0, now)
        itls = []
        freed = []
        for i in active:
            st = self._slots[i]
            if st.replay:
                self._replay_one(st)
                continue
            nxt0 = pick_token(logits[i], st.temperature, st.key(), clamp=True)
            if self._emit(st, nxt0, now, itls):
                freed.append(i)
        self._record_step(len(active), itls)
        self._retire(freed)

    def _decode(self, token, pos, tables) -> np.ndarray:
        """One decode step over every slot, the arenas written in place;
        returns the (S, V) float32 logits on the host."""
        logits = self._decode_exec({"token": token, "pos": pos,
                                    "tables": tables})
        return logits.cpu().numpy()  # synchronises

    # -- speculation ---------------------------------------------------- #
    def _verify(self, tokens, pos, ncand, tables, rung=None) -> np.ndarray:
        """One verify step over every slot (the linear one, or the tree
        one of ladder ``rung``), the arenas written in place; returns the
        (S, W, V) float32 logits on the host."""
        step = self._verify_execs[0 if rung is None else rung]
        logits = step({"tokens": tokens, "pos": pos, "ncand": ncand,
                       "tables": tables})
        return logits.cpu().numpy()  # synchronises

    def _commit(self, src, pos, tables) -> None:
        self._commit_exec({"src": src, "pos": pos, "tables": tables})

    def _may_speculate(self, st: _Slot) -> bool:
        """A demoted slot serves ``probe_interval`` plain rounds, then is
        re-probed with its acceptance EMA forgotten."""
        if not st.demoted:
            return True
        st.probe_in -= 1
        if st.probe_in > 0:
            return False
        st.demoted = False
        st.accept_ema = None
        st.spec_rounds = 0
        if self.spec.tree:
            st.tree_rung = self.spec.init_rung
        self.spec_metrics.record_reprobe()
        return True

    def _verify_fault(self, jobs, **ctx) -> bool:
        """The ``serving.verify`` fault site, crossed once per round
        after drafting: an injected transient demotes every speculating
        slot to plain decode for this round (drafts discarded, the
        drafter rewound) instead of failing its stream; a lost backend
        keeps its fatal meaning.  True when the round's drafts are
        dropped."""
        try:
            fault_point("serving.verify", name=self.name, k=self.spec.k,
                        speculating=len(jobs), **ctx)
        except TransientBackendError:
            for i in jobs:
                st = self._slots[i]
                self.draft.commit(i, 0, [])
                st.demoted = True
                st.probe_in = self.spec.probe_interval
                self.spec_metrics.record_demotion(fault=True)
                if _tracer.sampled(st.rid):
                    _tracer.instant("lm/demote", cat="serve",
                                    request_id=st.rid, slot=i,
                                    reason="verify_fault")
            return True
        return False

    def _track_acceptance(self, st: _Slot, rate: float,
                          finished: bool) -> bool:
        """Fold one round's acceptance rate into the slot's EMA; demote
        the slot (True) when it collapsed below ``demote_below`` after
        ``min_rounds`` rounds."""
        cfg = self.spec
        st.accept_ema = (rate if st.accept_ema is None
                         else cfg.ema_alpha * rate
                         + (1.0 - cfg.ema_alpha) * st.accept_ema)
        st.spec_rounds += 1
        if (not finished and st.spec_rounds >= cfg.min_rounds
                and st.accept_ema < cfg.demote_below):
            st.demoted = True
            st.probe_in = cfg.probe_interval
            self.spec_metrics.record_demotion()
            if _tracer.sampled(st.rid):
                _tracer.instant("lm/demote", cat="serve", request_id=st.rid,
                                reason="acceptance_collapse",
                                accept_ema=round(st.accept_ema, 4))
            return True
        return False

    def _step_spec(self):
        """One speculative round: draft k tokens per eligible slot, run
        the verify step over all k+1 candidate rows of every active slot,
        then walk each slot's rows emitting the accepted prefix plus one
        bonus/correction token: the offline trajectory under "replay".
        Rejection rewinds the position pointer only.  Demoted,
        chunk-admitted and budget-exhausted slots ride the round as
        one-row candidates."""
        cfg = self.spec
        jobs = {}
        for i, st in enumerate(self._slots):
            if st is None or not st.draft_ok or not self._may_speculate(st):
                continue
            # never draft past the budget: the round emits at most
            # k_eff + 1 tokens, and every verify write must stay inside
            # the chain allocated for prompt + max_new at admission
            k_eff = min(cfg.k, st.remaining - 1)
            if k_eff < 1:
                continue
            keys = None
            if st.temperature > 0.0 and st.step_keys is not None:
                keys = st.step_keys[st.step_idx:st.step_idx + k_eff]
            jobs[i] = (k_eff, st.temperature, keys)
        steps_before = self.draft.steps
        drafts = self.draft.draft_round(jobs)
        if self._verify_fault(jobs):
            drafts, jobs = {}, {}

        tokens = np.zeros((self.slots, cfg.k + 1), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        ncand = np.zeros((self.slots,), np.int32)
        tables = np.zeros((self.slots, self.table_width), np.int32)
        active = []
        for i, st in enumerate(self._slots):
            if st is None:
                continue
            active.append(i)
            ds = drafts[i][0] if i in drafts else ()
            tokens[i, 0] = st.last0
            tokens[i, 1:1 + len(ds)] = ds
            ncand[i] = 1 + len(ds)
            pos[i] = st.pos_next
            tables[i] = st.table
        if not active:
            return
        t0 = time.perf_counter()
        with _tracer.span("lm/verify_step", cat="serve", active=len(active),
                          speculating=len(jobs)):
            logits = self._verify(tokens, pos, ncand, tables)  # (S, W, V)
        now = time.perf_counter()
        self._trace_rounds("lm/verify_round", active, t0, now,
                           speculating=lambda i: i in jobs)
        itls = []
        freed = []
        n_emitted = 0
        for i in active:
            st = self._slots[i]
            if st.replay:
                # a lost-payload resume rides the round as a one-row
                # candidate (its draft_ok is False)
                self._replay_one(st)
                continue
            ds, qrows, _ = drafts.get(i, ((), None, ()))
            k_eff = len(ds)
            emitted = []
            accepted = 0
            finished = False
            for j in range(k_eff + 1):
                e = accept_row(logits[i, j], ds[j] if j < k_eff else None,
                               st.temperature, st.key(), cfg.sampling,
                               qrows[j] if qrows is not None
                               and j < k_eff else None)
                emitted.append(e)
                if self._emit(st, e, now, itls):
                    finished = True
                    break
                if j >= k_eff or ds[j] != e:
                    break
                accepted += 1
            n_emitted += len(emitted)
            if k_eff:
                self.spec_metrics.record_round(k_eff, accepted)
                self._track_acceptance(st, accepted / k_eff, finished)
            if finished:
                freed.append(i)
            elif st.draft_ok:
                if k_eff:
                    self.draft.commit(i, accepted, emitted)
                else:
                    self.draft.push(i, emitted[0])
        self.spec_metrics.record_verify_round(
            bool(jobs), n_emitted, self.draft.steps - steps_before)
        self._record_step(len(active), itls)
        self._retire(freed)

    def _step_spec_tree(self):
        """One tree-speculative round (replay only): each eligible slot
        picks a ladder rung (its adaptive ``tree_rung``, lowered until
        the shape fits its remaining budget), the drafter proposes the
        spine plus ranked runner-up alternates, and one verify step at
        the round's widest rung (narrower slots truncated by ``n_cand``)
        scores every node.  The host walks each slot's tree from the
        root, emitting the offline draw at every accepted node.  A slot
        that accepted an alternate has that node's k/v copied down to
        its position offset afterwards (``_tree_commit_paged``, skipped
        on spine-only rounds).

        The acceptance EMA drives rung promotion at ``promote_above``,
        step-down at ``stepdown_below`` and demotion to plain decode
        below ``demote_below``; a re-probed slot restarts at
        ``init_rung``."""
        cfg = self.spec
        shapes = self._tree_shapes
        top = len(shapes) - 1
        jobs = {}
        for i, st in enumerate(self._slots):
            if st is None or not st.draft_ok or not self._may_speculate(st):
                continue
            # budget clamp: a shape stores nodes at pos .. pos+W-1 and
            # emits at most max_depth+1 <= W tokens, so W <= remaining
            # keeps every write and emission inside the chain
            rung = min(st.tree_rung, top)
            while rung >= 0 and shapes[rung].width > st.remaining:
                rung -= 1
            if rung >= 0:
                jobs[i] = rung
        djobs = {}
        for i, rung in jobs.items():
            st = self._slots[i]
            shp = shapes[rung]
            keys = None
            if st.temperature > 0.0 and st.step_keys is not None:
                keys = st.step_keys[st.step_idx:st.step_idx + shp.spine]
            djobs[i] = (shp.spine, st.temperature, keys, shp.alt_counts)
        steps_before = self.draft.steps
        drafts = self.draft.draft_round(djobs)
        if self._verify_fault(jobs, tree=True):
            drafts, jobs = {}, {}

        round_rung = max(jobs.values(), default=0)
        w = shapes[round_rung].width
        tokens = np.zeros((self.slots, w), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        ncand = np.zeros((self.slots,), np.int32)
        tables = np.zeros((self.slots, self.table_width), np.int32)
        active = []
        for i, st in enumerate(self._slots):
            if st is None:
                continue
            active.append(i)
            tokens[i, 0] = st.last0
            pos[i] = st.pos_next
            tables[i] = st.table
            ncand[i] = 1
            if i in jobs:
                shp = shapes[jobs[i]]
                ds, _, alts = drafts[i]
                for j in range(1, shp.width):
                    if j <= shp.spine:
                        tokens[i, j] = ds[j - 1]
                        continue
                    p = shp.parents[j]
                    ranked = alts[p] if p < len(alts) else ()
                    r = shp.alt_rank[j]
                    # an unfillable alternate keeps token 0: under replay
                    # it is accepted only if 0 is the offline emission
                    if r < len(ranked):
                        tokens[i, j] = ranked[r]
                ncand[i] = shp.width
        if not active:
            return
        t0 = time.perf_counter()
        with _tracer.span("lm/verify_step", cat="serve", active=len(active),
                          speculating=len(jobs), tree_w=w):
            logits = self._verify(tokens, pos, ncand, tables, round_rung)
        now = time.perf_counter()
        self._trace_rounds("lm/verify_round", active, t0, now,
                           speculating=lambda i: i in jobs)
        itls = []
        freed = []
        n_emitted = 0
        commit_src = None     # built when some slot accepts an alternate
        for i in active:
            st = self._slots[i]
            if st.replay:
                self._replay_one(st)
                continue
            shp = shapes[jobs[i]] if i in jobs else None
            emitted = []
            node = 0
            accepted = spine_ok = alt_ok = 0
            finished = False
            while True:
                e = pick_token(logits[i, node], st.temperature, st.key(),
                               clamp=True)
                emitted.append(e)
                if self._emit(st, e, now, itls):
                    finished = True
                    break
                nxt = None
                if shp is not None:
                    nxt = next((c for c in shp.children[node]
                                if int(tokens[i, c]) == e), None)
                if nxt is None:
                    break
                accepted += 1
                if nxt <= shp.spine:
                    spine_ok += 1
                else:
                    # the path left the spine: schedule this node's k/v
                    # copy-down (alternates are leaves: one per slot)
                    alt_ok += 1
                    if commit_src is None:
                        commit_src = np.tile(np.arange(
                            1, self._commit_dmax + 1, dtype=np.int32),
                            (self.slots, 1))
                    commit_src[i, accepted - 1] = nxt
                node = nxt
            n_emitted += len(emitted)
            if shp is not None:
                self.spec_metrics.record_round(shp.width - 1, accepted)
                self.spec_metrics.record_tree_slot(
                    shp.max_depth, shp.width, len(emitted), alt_ok)
                if not self._track_acceptance(st, accepted / shp.max_depth,
                                              finished):
                    if st.accept_ema >= cfg.promote_above:
                        st.tree_rung = min(st.tree_rung + 1, top)
                    elif st.accept_ema < cfg.stepdown_below:
                        st.tree_rung = max(st.tree_rung - 1, 0)
            if finished:
                freed.append(i)
            elif st.draft_ok:
                if shp is not None:
                    # the drafter's cache tracks only the SPINE: rewind
                    # past accepted spine drafts, catch up on the rest
                    self.draft.commit(i, spine_ok, emitted)
                else:
                    self.draft.push(i, emitted[0])
        if commit_src is not None:
            with _tracer.span("lm/tree_commit", cat="serve"):
                self._commit(commit_src, pos, tables)
        self.spec_metrics.record_verify_round(
            bool(jobs), n_emitted, self.draft.steps - steps_before)
        self._record_step(len(active), itls)
        self._retire(freed)

    # -- tiered KV memory (host tier + hibernation) --------------------- #
    def _demote_block(self, path, block: int) -> None:
        """Radix ``on_evict`` hook: export the victim block's rows (with
        its scales when quantized) and demote them into the host tier
        keyed by the block's token-prefix path.  Runs on the worker,
        after the last step that wrote the block, while it is still
        allocated."""
        self.kvtier.put(("radix",) + tuple(path),
                        self.pool.export_chain([block]))
        _tracer.instant("kvtier/demote", cat="serve", block=int(block),
                        depth=len(path))

    def _promote_extend(self, prompt0, matched: List[int], *,
                        rid=None) -> List[int]:
        """Extend a radix-matched head with consecutive host-tier
        blocks: each surviving continuation block is adopted back into
        the arenas, registered in the trie and appended to the match, so
        the admission prefills only past the combined prefix.
        Opportunistic: pool pressure or a tier miss returns the match as
        it was."""
        B = self.block_len
        cap = max(0, (prompt0.shape[0] - 1) // B)
        m = len(matched)
        if m >= cap or self.radix is None:
            return matched
        keys = block_path(prompt0, B, cap)
        payloads = []
        for i in range(m, cap):
            p = self.kvtier.get(("radix",) + keys[:i + 1])
            if p is None:
                break
            payloads.append(p)
        if not payloads:
            return matched
        quant = self.kv_quant is not None
        L, _, H, Bl, D = self.pool.shape
        if (payloads[0]["k"].shape[1:] != (L, H, Bl, D)
                or quant != ("ks" in payloads[0])):
            # entries of another geometry or precision under the same
            # store name: not promotable into this pool
            return matched
        wire = {kk: np.concatenate([p[kk] for p in payloads], axis=0)
                for kk in payloads[0] if kk in ("k", "v", "ks", "vs")}
        nbytes = sum(int(a.nbytes) for a in wire.values())
        rid_args = {"request_id": rid} if _tracer.sampled(rid) else {}
        t0 = time.perf_counter()
        with _tracer.span("kvtier/promote", cat="serve",
                          blocks=len(payloads), bytes=nbytes, **rid_args):
            try:
                fresh = self.pool.adopt_chain(
                    wire["k"], wire["v"], wire.get("ks"), wire.get("vs"))
            except PoolExhausted:
                # never deepen the pressure promotion tries to relieve
                return matched
        self.kvtier.record_promote(nbytes, time.perf_counter() - t0)
        out = list(matched) + fresh
        # future admissions share the promoted blocks from the arenas,
        # and the trie's reference keeps them demotable again
        self.radix.insert(prompt0[:len(out) * B], out)
        self.radix.record_saved(len(fresh) * B)
        return out

    def hibernate(self, stream: LMStream, *,
                  timeout: Optional[float] = 30.0) -> bool:
        """Swap an idle stream out of its decode slot: its written KV
        chain moves to the host tier (``("session", rid)``), its slot and
        every block free, and its sampling state is kept so
        :meth:`resume` continues it bit-exactly.  Blocks until the worker
        performs the swap at a round boundary.  True once hibernated;
        False when the stream is not seated in a decode slot (queued,
        replaying, or finished; a stream whose first token has just
        landed counts as seated).  ``timeout`` bounds the wait for the
        worker to take the request; once taken, the answer waits for the
        swap itself, so True and False are what happened."""
        if self.kvtier is None:
            raise ValueError("hibernate requires a kvtier (HostBlockStore)")
        rid = stream.request_id
        with self._cv:
            if rid in self._hibernated:
                return True
            seated = rid in self._seating or any(
                st is not None and st.rid == rid and not st.replay
                for st in self._slots)
            if not seated or stream.done():
                return False
            self._hibernate_req.add(rid)
            self._cv.notify_all()
            self._cv.wait_for(lambda: rid not in self._hibernate_req,
                              timeout)
            if rid in self._hibernate_req:
                # withdrawn before the worker took it: nothing happened
                self._hibernate_req.discard(rid)
                return False
            self._cv.wait_for(lambda: rid not in self._hibernating)
            return rid in self._hibernated

    def resume(self, stream: LMStream) -> bool:
        """Re-admit a hibernated stream: its chain is adopted back into
        the arenas (or, when the tier lost it, the prompt re-prefills and
        the emitted tokens replay through decode) and decode continues
        at the exact token it left off.  Resumes rank ahead of fresh
        admissions.  False when the stream is not hibernated."""
        rid = stream.request_id
        with self._cv:
            if self._closing:
                raise ServingClosed("LMServingEngine is closed")
            hib = self._hibernated.pop(rid, None)
            if hib is None:
                return False
            self._resume_q.append(hib)
            self._cv.notify_all()
        if _tracer.sampled(rid):
            _tracer.instant("lm/resume_enqueue", cat="serve", request_id=rid,
                            hibernated_s=round(
                                time.perf_counter() - hib.hibernated_at, 4))
        return True

    def _service_hibernations(self) -> None:
        """Worker-side swap-out of each requested seated slot; requests
        for streams no longer seated are dropped so their waiters
        unblock."""
        with self._cv:
            todo = [(i, st) for i, st in enumerate(self._slots)
                    if st is not None and st.rid in self._hibernate_req
                    and not st.replay]
            self._hibernating.update(st.rid for _, st in todo)
            self._hibernate_req.clear()     # taken, or stale: not seated
            self._cv.notify_all()
        for i, st in todo:
            try:
                self._hibernate_one(i, st)
            finally:
                with self._cv:
                    self._hibernating.discard(st.rid)
                    self._cv.notify_all()

    def _hibernate_one(self, slot: int, st: _Slot) -> None:
        n_used = self.pool.blocks_for(st.pos_next)
        rid_args = ({"request_id": st.rid}
                    if _tracer.sampled(st.rid) else {})
        with _tracer.span("kvtier/hibernate", cat="serve", slot=slot,
                          blocks=n_used, **rid_args):
            # the export's copies finish before the payload is stored
            self.kvtier.put(("session", st.rid),
                            self.pool.export_chain(st.blocks[:n_used]))
        hib = _Hibernated(st, n_used)
        self.pool.release(st.blocks)
        if self.draft is not None:
            # the drafter's per-slot cache does not hibernate: the
            # resumed stream rides plain decode (still exact)
            self.draft.release(slot)
        with self._cv:
            self._slots[slot] = None
            self._free.append(slot)
            self._n_active -= 1
            self._hibernated[st.rid] = hib
            self.hibernations += 1

    def _alloc_or_evict(self, n: int, take=None) -> Optional[List[int]]:
        """``n`` fresh blocks from ``take()`` (default ``pool.alloc(n)``;
        an adopt passes its own), evicting radix tails once under pool
        pressure; None if they still do not fit."""
        take = take or (lambda: self.pool.alloc(n))
        try:
            return take()
        except PoolExhausted:
            if self.radix is not None:
                self.radix.evict(n - self.pool.free_count)
            try:
                return take()
            except PoolExhausted:
                return None

    def _resume_into(self, slot: int, hib: _Hibernated) -> bool:
        """Seat a hibernated stream back into ``slot``.  False (defer)
        under pool pressure; a fetched payload stays on the handle
        across deferrals, never re-read or lost."""
        stream = hib.stream
        t = int(stream.prompt.shape[0])
        prompt0 = stream.prompt.astype(np.int32) - 1
        max_new = int(stream.max_new)
        need_total = self.pool.blocks_for(t + max_new)
        B = self.block_len
        rid_args = ({"request_id": hib.rid}
                    if _tracer.sampled(hib.rid) else {})
        req = _Request(stream, prompt0, max_new, hib.temperature, hib.eos0,
                       None, hib.step_keys, hib.rid)
        if not hib.fetched:
            hib.payload = self.kvtier.get(("session", hib.rid), pop=True)
            hib.fetched = True
        if hib.payload is not None:
            payload = hib.payload
            n_wire = int(payload["k"].shape[0])
            extra = need_total - n_wire
            nbytes = sum(int(a.nbytes) for a in payload.values())
            t0 = time.perf_counter()
            with _tracer.span("kvtier/promote", cat="serve", blocks=n_wire,
                              bytes=nbytes, session=1, **rid_args):
                fresh = self._alloc_or_evict(
                    n_wire + extra, lambda: self.pool.adopt_chain(
                        payload["k"], payload["v"], payload.get("ks"),
                        payload.get("vs"), extra_blocks=extra))
                if fresh is None:
                    return False
            self.kvtier.record_promote(nbytes, time.perf_counter() - t0)
            if self.radix is not None and t // B:
                self.radix.insert(prompt0[:(t // B) * B], fresh[:t // B])
            self._seat_resumed(req, fresh, slot, pos_next=hib.pos_next,
                               last0=hib.last0, remaining=hib.remaining,
                               step_idx=hib.step_idx, replay=())
            _tracer.instant("lm/resume", cat="serve", slot=slot,
                            wire_blocks=n_wire, **rid_args)
            return True
        # the payload was lost (dropped for capacity, or a corrupt
        # spill): the prompt's KV recomputes through the same prefill
        # admission ran, the generated tokens' KV by replaying them
        # through the decode step that wrote the originals; nothing is
        # emitted again
        emitted0 = np.asarray(stream.generated, np.int32) - 1
        matched: List[int] = []
        if self.radix is not None:
            matched = self.radix.match(prompt0)
            matched = self._promote_extend(prompt0, matched, rid=hib.rid)
        fresh = self._alloc_or_evict(need_total - len(matched))
        if fresh is None:
            if matched:
                self.pool.release(matched)
            return False
        blocks = matched + fresh
        self.resume_re_prefills += 1
        pf = _Prefill(req, blocks, slot, len(matched) * B)
        try:
            while not self._prefill_chunk(pf):
                pass
        except BaseException:
            self.pool.release(blocks)
            raise
        if self.radix is not None and t // B:
            self.radix.insert(prompt0[:(t // B) * B], blocks[:t // B])
        self._seat_resumed(req, blocks, slot, pos_next=t,
                           last0=int(emitted0[0]), remaining=max_new - 1,
                           step_idx=0,
                           replay=tuple(int(x) for x in emitted0[1:]))
        _tracer.instant("lm/resume", cat="serve", slot=slot, re_prefill=1,
                        replay=len(emitted0) - 1, **rid_args)
        return True

    def _seat_resumed(self, req: _Request, blocks: List[int], slot: int, *,
                      pos_next: int, last0: int, remaining: int,
                      step_idx: int, replay) -> None:
        table = np.zeros((self.table_width,), np.int32)
        table[:len(blocks)] = blocks
        st = _Slot(req, pos_next, last0, blocks, table)
        st.remaining = int(remaining)
        st.step_idx = int(step_idx)
        st.replay = deque(replay)
        # a resumed stream rides plain decode (draft_ok stays False) and
        # interrupts the ITL stream the way a prefill does
        self._prefill_since_step = True
        with self._cv:
            self._slots[slot] = st
            self._n_active += 1
            self.resumes += 1

    def _fail_all(self, error: BaseException) -> None:
        with self._cv:
            pending = [r.stream for r in self._queue]
            self._queue.clear()
            for h in self._adopt_q:
                pending.append(h.stream)
                if h.matched:
                    self.pool.release(h.matched)
            self._adopt_q.clear()
            for pf in self._prefilling:
                pending.append(pf.req.stream)
                self.pool.release(pf.blocks)
                self._free.append(pf.slot)
            self._prefilling.clear()
            for i, st in enumerate(self._slots):
                if st is not None:
                    pending.append(st.stream)
                    self.pool.release(st.blocks)
                    self._slots[i] = None
                    self._free.append(i)
            self._n_active = 0
            if self.draft is not None:
                self.draft.release_all()
            # hibernated and resuming streams hold no blocks (their
            # chains live in the host tier), but their clients wait too
            pending.extend(h.stream for h in self._hibernated.values())
            self._hibernated.clear()
            pending.extend(h.stream for h in self._resume_q)
            self._resume_q.clear()
            self._hibernate_req.clear()
            self._hibernating.clear()
            self._cv.notify_all()
        for s in pending:
            s._finish(error=error)

    # ------------------------------------------------------------------ #
    def kvcache_stats(self) -> dict:
        """The pool's and the trie's state."""
        out = self.pool.stats()
        out["table_width"] = self.table_width
        out["prefix_cache"] = (self.radix.stats()
                               if self.radix is not None else None)
        return out

    def kvcache_headroom(self) -> int:
        """How many more worst-case requests (a full ``cache_len`` chain
        each) the free blocks hold now: the scale-up check's gate, so
        added capacity is backed by KV memory."""
        return self.pool.free_count // self.table_width

    def stats(self) -> dict:
        with self._cv:
            queued = len(self._queue)
            active = self._n_active
            hibernated = len(self._hibernated)
            slot_limit = self._slot_limit
            max_queue = self._max_queue
            prefilling = len(self._prefilling)
            adopt_q = len(self._adopt_q)
        return {
            "name": self.name,
            "device": str(self.device),
            "slots": self.slots,
            "slot_limit": slot_limit,
            "max_queue": max_queue,
            "active": active,
            "queued": queued,
            "phase": self.phase,
            "prefilling": prefilling,
            "adopt_queue": adopt_q,
            "max_prefill_chunk_tokens": self._chunk_cap,
            "migrated": self.migrated,
            "adopted": self.adopted,
            "re_prefills": self.re_prefills,
            "cache_len": self.cache_len,
            "block_len": self.block_len,
            "attention_impl": self.attention_impl,
            "prefill_attention": {
                str(b): impl if blocks is None else "%s %dx%d" % (
                    impl, blocks[0], blocks[1])
                for b, (impl, blocks) in sorted(self._prefill_attn.items())},
            "decode_attn": self.decode_attn,
            "kv_quant": self.kv_quant,
            "quant_dtype": params_dtype_tag(self._params),
            "prefill_buckets": list(self.prefill_buckets),
            "prefill_cache": self.prefill_cache.stats(),
            "prefix_prefill_cache": self.prefix_prefill_cache.stats(),
            "cuda_graphs": self.graphs.stats(),
            "kvcache": self.kvcache_stats(),
            "kvtier": (self.kvtier.stats()
                       if self.kvtier is not None else None),
            "radix_summary": (self.radix_summary.stats()
                              if self.radix_summary is not None else None),
            "hibernated": hibernated,
            "hibernations": self.hibernations,
            "resumes": self.resumes,
            "resume_re_prefills": self.resume_re_prefills,
            "honor_lifecycle": self.honor_lifecycle,
            "lifecycle": self.lifecycle_stats(),
            "metrics": self.metrics.snapshot(),
            "spec": self._spec_stats(),
        }

    def lifecycle_stats(self) -> dict:
        with self._lc_lock:
            return dict(self.lifecycle)

    def _spec_stats(self) -> Optional[dict]:
        if self.spec is None:
            return None
        with self._cv:
            demoted = sum(1 for s in self._slots
                          if s is not None and s.demoted)
            rungs = [s.tree_rung if s is not None else None
                     for s in self._slots]
        out = self.spec.describe()
        out["demoted_slots"] = demoted
        out["draft"] = self.draft.describe()
        out["verify_compiles"] = self._verify_compiles
        if self.spec.tree:
            out["commit_compiles"] = self._commit_compiles
            out["slot_rungs"] = rungs
        out.update(self.spec_metrics.snapshot())
        return out

    def cache_buffer_pointers(self) -> tuple:
        """Device addresses of the k/v arenas (and of the int8 pool's
        scale arenas after them): the graphs captured them, so they stay
        fixed across steps, requests and every tier move."""
        arenas = [self.pool.k, self.pool.v]
        if self.pool.ks is not None:
            arenas += [self.pool.ks, self.pool.vs]
        return tuple(a.data_ptr() for a in arenas)

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Drain: stop admitting, finish queued + in-flight requests;
        after ``timeout`` the remainder resolve with ServingClosed, as do
        streams still hibernated."""
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        self._worker.join(timeout)
        if self._worker.is_alive():
            with self._cv:
                self._abort = True
                self._cv.notify_all()
            self._worker.join(5.0)
            self._fail_all(ServingClosed("engine closed before "
                                         "completion"))
        # drop this engine's ledger rows (the weakref providers would go
        # stale anyway; releasing keeps the table clean)
        try:
            from bigdl_tpu_torch.obs.ledger import get_ledger
            led = get_ledger()
            for sub, nm in self._ledger_keys:
                led.release(sub, nm)
        except Exception:
            pass

    def __enter__(self) -> "LMServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
