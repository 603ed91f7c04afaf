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
a graph's outputs live in a pool the next graph reuses.  Not ported
yet, and refused with ``NotImplementedError`` when asked for:
``kvtier``, ``migrate``/``adopt``, ``placement``, deadlines and
cancellation.
"""
from __future__ import annotations

import copy
import threading
import time
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
                                                   StepGraph)
from bigdl_tpu_torch.serving.errors import (PoolExhausted, RequestExceedsPool,
                                            ServingClosed, ServingQueueFull)
from bigdl_tpu_torch.serving.histogram import Histogram
from bigdl_tpu_torch.serving.kvcache import BlockPool, RadixCache
from bigdl_tpu_torch.serving.spec import (DraftModel, NgramDrafter,
                                          SpecConfig, SpecMetrics)
from bigdl_tpu_torch.serving.spec.verify import accept_row, pick_token
from bigdl_tpu_torch.utils import keychain


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
class LMStream:
    """Per-request handle: generated 1-based ids stream in as the engine
    decodes them.  ``tokens()`` iterates them as they land;
    ``result()`` blocks for prompt + generated ids."""

    def __init__(self, prompt_1b: np.ndarray, max_new: int):
        self.prompt = prompt_1b
        self.max_new = int(max_new)
        self._tokens: List[int] = []
        self._cond = threading.Condition()
        self._done = False
        self._error: Optional[BaseException] = None
        self.submitted_at = time.perf_counter()
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None

    def cancel(self) -> bool:
        raise _not_ported("cooperative cancellation", "11")

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
            self._cond.notify_all()

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
    decode worker records, callers read ``snapshot()``)."""

    def __init__(self, slots: int, throughput_window_s: float = 60.0):
        self._lock = threading.Lock()
        self.slots = int(slots)
        self.ttft = Histogram()
        self.itl = Histogram()
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

    def record_step(self, n_active: int, itls_s: Sequence[float]) -> None:
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
            for itl in itls_s:
                self.itl.observe(itl)

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
                "spec": (self.spec.snapshot()
                         if self.spec is not None else None),
            }


# ---------------------------------------------------------------------- #
class _Request:
    __slots__ = ("stream", "prompt0", "max_new", "temperature", "eos0",
                 "first_key", "step_keys")

    def __init__(self, stream, prompt0, max_new, temperature, eos0,
                 first_key, step_keys):
        self.stream = stream
        self.prompt0 = prompt0          # (t,) int32, 0-based
        self.max_new = max_new
        self.temperature = temperature
        self.eos0 = eos0                # 0-based eos id or None
        self.first_key = first_key      # (2,) uint32 or None
        self.step_keys = step_keys      # (max_new - 1, 2) uint32 or None


class _Slot:
    __slots__ = ("stream", "pos_next", "last0", "remaining", "step_idx",
                 "temperature", "eos0", "step_keys", "last_emit_at",
                 "blocks", "table", "draft_ok", "demoted", "accept_ema",
                 "spec_rounds", "probe_in", "tree_rung")

    def __init__(self, req: _Request, prompt_len: int, first0: int,
                 blocks: List[int], table: np.ndarray):
        self.stream = req.stream
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


class _Prefill:
    """An admitted request's prefill in progress: blocks are allocated,
    ``p`` tokens are in the arena; ``logits`` (host) once the last chunk
    ran."""

    __slots__ = ("req", "blocks", "slot", "p", "t", "logits")

    def __init__(self, req: _Request, blocks: List[int], slot: int,
                 matched_len: int):
        self.req = req
        self.blocks = blocks
        self.slot = slot
        self.p = matched_len
        self.t = req.prompt0.shape[0]
        self.logits = None


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
            kernel; its plain version on the CPU), ``"xla"`` (plain
            attention) or ``"auto"`` (flash on a CUDA device, plain on
            the CPU); ``None`` keeps the model's own rule.
        decode_attn: ``"paged_kernel"`` (the CUDA paged kernel; its
            plain version on the CPU), ``"gather"`` (dense gather of
            each chain) or ``"auto"`` (the kernel on a CUDA device, the
            gather on the CPU; always the gather with ``kv_quant``).
            Greedy streams agree across all of them.
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
                 name: str = "lm",
                 device=None):
        for what, val, item in (("kvtier", kvtier, "11"),
                                ("migrate (disaggregated serving)",
                                 migrate, "11"),
                                ("placement", placement, "11")):
            if val is not None:
                raise _not_ported(what, item)
        if isinstance(spec, int) and not isinstance(spec, bool):
            spec = SpecConfig(k=spec)
        if spec is not None and not isinstance(spec, SpecConfig):
            raise TypeError(f"spec must be a SpecConfig or an int, got "
                            f"{spec!r}")
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
        self._prefix_block_buckets = prefill_bucket_lengths(
            self.table_width, min_bucket=1)

        self.attention_impl = (
            "flash" if mha.resolve_use_flash(self.device, attention_impl)
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
        elif decode_attn == "auto":
            # no autotune cache yet: the kernel wherever it can run
            decode_attn = ("paged_kernel" if self.device.type == "cuda"
                           else "gather")
        self.decode_attn = decode_attn

        # -- the device steps, one graph per shape ---------------------- #
        self.graphs = GraphPool(self.device, capture=self.cuda_graphs)
        pool, attn = self.pool, self.attention_impl

        def _prefill_fn(params, buffers, x):
            del buffers  # part of the CompileCache signature only
            logits, k, v = _prefill_parts(model, params, x["ids"],
                                          x["len"] - 1, attention_impl=attn)
            _insert_blocks(pool.k, pool.v, k, v, x["insert"], pool.ks,
                           pool.vs)
            return logits

        self.prefill_cache = CompileCache(
            _prefill_fn, graphs=self.graphs, max_entries=max_cache_entries)

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
            max_entries=max_cache_entries)

        def _decode_fn(x):
            return _decode_step_paged(
                model, self._params, x["token"], x["pos"], x["tables"],
                pool.k, pool.v, pool.ks, pool.vs, attn_impl=decode_attn)[0]

        self._decode_exec = StepGraph(_decode_fn, self.graphs)

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
            self.spec_metrics = SpecMetrics()
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

                self._commit_exec = StepGraph(_commit_fn, self.graphs)

        self.metrics = LMMetrics(self.slots)
        self.metrics.spec = self.spec_metrics
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._free = list(range(self.slots))
        self._slots: List[Optional[_Slot]] = [None] * self.slots
        self._n_active = 0
        self._closing = False
        self._abort = False
        self._worker = threading.Thread(
            target=self._run, daemon=True, name=f"lm-serve-{name}")
        self._worker.start()

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

            return [StepGraph(_verify_fn, self.graphs)]
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

            steps.append(StepGraph(_tree_fn, self.graphs))
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
        if self._queue or self._n_active:
            raise RuntimeError(f"{what} runs before traffic")

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
            if self.draft is None:
                self._decode(np.zeros((self.slots,), np.int64), zeros, tables)
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
            return self.prefix_prefill_cache.warmup_inputs(
                self._params, self.model.buffers, inputs)

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
        ``generate`` at batch 1 does."""
        if deadline_s is not None:
            raise _not_ported("deadline_s (request deadlines)", "11")
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
        stream = LMStream(prompt, max_new)
        req = _Request(stream, prompt - 1, max_new, temp, eos0, first_key,
                       step_keys)
        with self._cv:
            if self._closing:
                raise ServingClosed("LMServingEngine is closed")
            if len(self._queue) >= self._max_queue:
                self.metrics.record_reject()
                raise ServingQueueFull(
                    f"admission queue full ({self._max_queue})")
            self._queue.append(req)
            self._cv.notify_all()
        self.metrics.record_submit()
        return stream

    def generate(self, prompt_ids, *, timeout: Optional[float] = None,
                 **kw) -> np.ndarray:
        """Sync convenience: submit + wait; returns (t + generated,)
        1-based ids for one prompt."""
        return self.submit(prompt_ids, **kw).result(timeout=timeout)

    # -- worker -------------------------------------------------------- #
    def _run(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.no_grad():  # grad mode is per thread
                self._loop()
        except Exception as e:  # noqa: BLE001 - the worker's boundary:
            # every waiting client gets the error instead of hanging
            self._fail_all(e)
            return
        self._fail_all(ServingClosed("engine closed before completion"))

    def _loop(self):
        while True:
            with self._cv:
                while (not self._queue and not self._n_active
                       and not self._closing and not self._abort):
                    self._cv.wait()
                if self._abort:
                    return
                if self._closing and not self._queue and not self._n_active:
                    return
                admits = []
                while self._free and self._queue:
                    admits.append((self._free.pop(), self._queue.popleft()))
            deferred = []
            for slot, req in admits:
                try:
                    admitted = self._admit(slot, req)
                except Exception as e:  # noqa: BLE001 - fail this request
                    req.stream._finish(error=e)
                    with self._cv:
                        self._free.append(slot)
                else:
                    if not admitted:
                        deferred.append((slot, req))
            if deferred:
                # pool pressure: requeue at the FRONT (FIFO order kept)
                # and return the slots; blocks free as streams finish
                with self._cv:
                    for slot, req in reversed(deferred):
                        self._free.append(slot)
                        self._queue.appendleft(req)
                    if not self._n_active:
                        self._cv.wait(0.05)
            if self._n_active:
                if self.draft is None:
                    self._step()
                elif self.spec.tree:
                    self._step_spec_tree()
                else:
                    self._step_spec()

    def _admit(self, slot: int, req: _Request) -> bool:
        """Prefill + insert one request into ``slot``.  Returns False
        (defer) when the pool can't supply its blocks right now, even
        after evicting unreferenced radix tails."""
        t = req.prompt0.shape[0]
        need_total = self.pool.blocks_for(t + req.max_new)
        matched: List[int] = []
        if self.radix is not None:
            matched = self.radix.match(req.prompt0)  # retains for us
        n_new = need_total - len(matched)
        try:
            fresh = self.pool.alloc(n_new)
        except PoolExhausted:
            if self.radix is not None:
                self.radix.evict(n_new - self.pool.free_count)
            try:
                fresh = self.pool.alloc(n_new)
            except PoolExhausted:
                if matched:
                    self.pool.release(matched)
                return False
        blocks = matched + fresh
        pf = _Prefill(req, blocks, slot, len(matched) * self.block_len)
        try:
            while not self._prefill_chunk(pf):
                pass
            self._finish_prefill(pf)
        except BaseException:
            self.pool.release(blocks)
            raise
        return True

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
        rem = t - p
        ts = rem if rem <= self.prefill_buckets[-1] else self._chunk_full
        ids = np.zeros((1, self.bucket_for(ts)), np.int64)
        ids[0, :ts] = req.prompt0[p:p + ts]
        x = self._prefill_x(ids, ts, p, pf.blocks)
        cache = self.prefill_cache if p == 0 else self.prefix_prefill_cache
        logits = cache(self._params, self.model.buffers, x)
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
        first0 = pick_token(pf.logits[0], req.temperature, req.first_key,
                            clamp=False)
        req.stream._emit(first0 + 1)
        self.metrics.record_first_token(
            req.stream.first_token_at - req.stream.submitted_at)
        if req.max_new == 1 or (req.eos0 is not None
                                and first0 == req.eos0):
            req.stream._finish()
            self.metrics.record_complete()
            self.pool.release(blocks)
            with self._cv:
                self._free.append(slot)
            return
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

    def _retire(self, freed: List[int]) -> None:
        """Return finished slots and their blocks."""
        if not freed:
            return
        with self._cv:
            for i in freed:
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
        logits = self._decode(token, pos, tables)
        now = time.perf_counter()
        itls = []
        freed = []
        for i in active:
            st = self._slots[i]
            nxt0 = pick_token(logits[i], st.temperature, st.key(), clamp=True)
            if self._emit(st, nxt0, now, itls):
                freed.append(i)
        self.metrics.record_step(len(active), itls)
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
        logits = self._verify(tokens, pos, ncand, tables)  # (S, W, V)
        now = time.perf_counter()
        itls = []
        freed = []
        n_emitted = 0
        for i in active:
            st = self._slots[i]
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
        self.metrics.record_step(len(active), itls)
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
        logits = self._verify(tokens, pos, ncand, tables, round_rung)
        now = time.perf_counter()
        itls = []
        freed = []
        n_emitted = 0
        commit_src = None     # built when some slot accepts an alternate
        for i in active:
            st = self._slots[i]
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
            self._commit(commit_src, pos, tables)
        self.spec_metrics.record_verify_round(
            bool(jobs), n_emitted, self.draft.steps - steps_before)
        self.metrics.record_step(len(active), itls)
        self._retire(freed)

    def _fail_all(self, error: BaseException) -> None:
        with self._cv:
            pending = [r.stream for r in self._queue]
            self._queue.clear()
            for i, st in enumerate(self._slots):
                if st is not None:
                    pending.append(st.stream)
                    self.pool.release(st.blocks)
                    self._slots[i] = None
                    self._free.append(i)
            self._n_active = 0
            if self.draft is not None:
                self.draft.release_all()
            self._cv.notify_all()
        for s in pending:
            s._finish(error=error)

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        with self._cv:
            queued = len(self._queue)
            active = self._n_active
        kv = self.pool.stats()
        kv["table_width"] = self.table_width
        kv["prefix_cache"] = (self.radix.stats()
                              if self.radix is not None else None)
        return {
            "name": self.name,
            "device": str(self.device),
            "slots": self.slots,
            "active": active,
            "queued": queued,
            "cache_len": self.cache_len,
            "block_len": self.block_len,
            "attention_impl": self.attention_impl,
            "decode_attn": self.decode_attn,
            "kv_quant": self.kv_quant,
            "quant_dtype": params_dtype_tag(self._params),
            "prefill_buckets": list(self.prefill_buckets),
            "prefill_cache": self.prefill_cache.stats(),
            "prefix_prefill_cache": self.prefix_prefill_cache.stats(),
            "cuda_graphs": self.graphs.stats(),
            "kvcache": kv,
            "metrics": self.metrics.snapshot(),
            "spec": self._spec_stats(),
        }

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
        """Device addresses of the k/v arenas: the graphs captured them,
        so they stay fixed across steps and requests."""
        return self.pool.k.data_ptr(), self.pool.v.data_ptr()

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Drain: stop admitting, finish queued + in-flight requests;
        after ``timeout`` the remainder resolve with ServingClosed."""
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

    def __enter__(self) -> "LMServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
