"""The drafter half of draft-verify speculation (port of
``bigdl_tpu/serving/spec/draft.py``).

``DraftModel`` wraps a cheap ``TransformerLM`` (float, or the target's
int8 ``quantize()`` clone, the engine's default) and runs it k
tokens ahead per slot against its OWN dense KV arena, (L, S, H,
cache_len + 1, D) on the engine's device: one contiguous region per
slot, no paging (the verifier never reads it).  Row ``cache_len`` is a
scratch position that absorbs idle slots' writes.  Each shape runs one
fixed-shape function, a captured CUDA graph on the card (the engine's
``cuda_graphs``, in the engine's graph pool): the batched decode step
over all S slots (``_decode_step_slots``; ``decode_compiles`` is its
bounded-executables witness) and, per prompt bucket, the prefill
(``_prefill_parts``, the flash kernel on the card) with its slot insert
(``prefill_cache``).
Drafting k tokens for the speculating slots costs ``max(pending) + k -
1`` batched decode steps a round; slots whose chains finish early idle
on the scratch row.

State discipline: the engine emits tokens the drafter has not attended
yet (the bonus token always, the k-th draft when all are accepted).
Each slot carries ``pending``, emitted tokens not yet fed, and every
draft round first catches the slot up.  Rollback after a partial
acceptance rewinds ``q_next``; stale rows above it are masked by
position until overwritten.

``NgramDrafter`` is the zero-model prompt-lookup drafter with the same
surface."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.models.transformer.generate import (_decode_step_slots,
                                                         _prefill_parts)
from bigdl_tpu_torch.quant.transform import (params_compute_tag,
                                             params_dtype_tag)
from bigdl_tpu_torch.serving.compile_cache import (CompileCache, GraphPool,
                                                   StepGraph)
from bigdl_tpu_torch.serving.spec.verify import draft_pick
from bigdl_tpu_torch.utils import keychain

# the n-gram drafter's lookup window: suffix matching scans at most the
# last this many tokens of a slot's context
_NGRAM_WINDOW = 4096


def _ranked_alternates(logits_row: np.ndarray, temperature: float, key,
                       picked: int, n: int) -> List[int]:
    """The drafter's ``n`` next-best proposals from ONE logits row, the
    tree verifier's alternate branches at no extra drafter step.  Greedy
    ranks raw logits; a sampled row ranks the chain key's
    Gumbel-perturbed scores (categorical is Gumbel-argmax), so the
    alternates are that draw's runner-ups.  ``picked`` (the spine draft)
    is excluded."""
    z = np.asarray(logits_row, np.float64)
    if temperature > 0.0 and key is not None:
        t = max(temperature, 1e-6)
        z = z / t + keychain.gumbel(key, (z.shape[0],)).astype(np.float64)
    order = np.argsort(-z, kind="stable")
    out: List[int] = []
    for tok in order:
        tok = int(tok)
        if tok == int(picked):
            continue
        out.append(tok)
        if len(out) >= n:
            break
    return out


def _insert_slot_dense(k_cache, v_cache, k_new, v_new, slot):
    """Write a prefilled prompt's k/v (L, 1, H, Tb, D) into one slot's
    rows of the dense caches (L, S, H, C+1, D) from position 0, in
    place; ``slot`` is a (1,) int tensor on the caches' device.
    Bucket-padding rows land above the prompt, masked until decode
    overwrites them."""
    tb = k_new.shape[3]
    idx = slot.reshape(1).long()
    k_cache[:, idx, :, :tb] = k_new.to(k_cache.dtype)
    v_cache[:, idx, :, :tb] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


class _DraftSlot:
    __slots__ = ("q_next", "pending", "draft_base", "last_k")

    def __init__(self, prompt_len: int):
        self.q_next = prompt_len   # next drafter cache position to write
        self.pending: List[int] = []  # emitted, not yet fed (0-based)
        self.draft_base = prompt_len  # position of draft_1 last round
        self.last_k = 0            # k_eff of the last draft round


class DraftModel:
    """Runs the drafter for every speculating slot of one engine."""

    def __init__(self, model, *, slots: int, cache_len: int,
                 prefill_buckets, max_cache_entries: int = 16,
                 sampling: str = "replay",
                 graphs: Optional[GraphPool] = None):
        if model.params is None:
            raise ValueError("the draft model has no params: call "
                             "model.build(seed) or set model.params")
        self.model = model
        self.device = model.device
        self.slots = int(slots)
        self.cache_len = int(cache_len)
        if model.max_len < self.cache_len:
            raise ValueError(
                f"draft model max_len ({model.max_len}) is smaller than "
                f"the engine cache_len ({cache_len}): the drafter must "
                "cover every position the target can reach")
        self.prefill_buckets = tuple(sorted(set(
            int(b) for b in prefill_buckets)))
        self.sampling = sampling
        self._params = model.params
        self.dtype_tag = params_dtype_tag(self._params)
        self.compute_mode = params_compute_tag(self._params) or "f32"
        L = model.n_layers
        H, D = model._mha.n_head, model._mha.head_dim
        # scratch row at index cache_len: idle slots in a batched draft
        # step write there (garbage, masked for every real position)
        self.scratch_pos = self.cache_len
        shape = (L, self.slots, H, self.cache_len + 1, D)
        dt = self._params["embed"].dtype
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        self.steps = 0             # drafter decode steps (overhead meter)
        self.graphs = (graphs if graphs is not None
                       else GraphPool(self.device, capture=False))
        k, v = self.k, self.v

        def _prefill_fn(params, buffers, x):
            del buffers
            _, kn, vn = _prefill_parts(model, params, x["ids"], x["len"] - 1)
            _insert_slot_dense(k, v, kn, vn, x["slot"])

        self.prefill_cache = CompileCache(
            _prefill_fn, graphs=self.graphs, max_entries=max_cache_entries,
            name="draft/insert")

        def _decode_fn(x):
            logits, _, _ = _decode_step_slots(model, self._params, x["token"],
                                              x["pos"], k, v)
            return logits

        self._decode_exec = StepGraph(_decode_fn, self.graphs,
                                      name="draft/decode",
                                      key=f"slots={self.slots}")
        self._st: List[Optional[_DraftSlot]] = [None] * self.slots

    @property
    def arena_bytes(self) -> int:
        """Device bytes of the drafter's dense k + v arena."""
        return 2 * self.k.numel() * self.k.element_size()

    @property
    def decode_compiles(self) -> int:
        """Decode graphs made: exactly one once warm."""
        return self._decode_exec.compiles

    # -- device steps --------------------------------------------------- #
    @staticmethod
    def _prefill_x(ids0: np.ndarray, t: int, slot: int) -> dict:
        return {"ids": ids0.astype(np.int64), "len": np.int32(t),
                "slot": np.asarray([slot], np.int64)}

    def _decode(self, token: np.ndarray, pos: np.ndarray) -> np.ndarray:
        logits = self._decode_exec({"token": token, "pos": pos})
        return logits.cpu().numpy()      # synchronises; (S, V) float32

    def warmup(self) -> int:
        """Make each prefill bucket's entry and the decode step before
        traffic (each runs once: the prefills write slot 0's rows, which
        an admission rewrites, and the decode the scratch row); returns
        the number of prefill entries newly made."""
        n = self.prefill_cache.warmup_inputs(
            self._params, self.model.buffers,
            [self._prefill_x(np.zeros((1, b), np.int64), b, 0)
             for b in self.prefill_buckets])
        self._decode(np.zeros((self.slots,), np.int64),
                     np.full((self.slots,), self.scratch_pos, np.int64))
        return n

    # -- per-slot lifecycle --------------------------------------------- #
    def can_draft(self, prompt_len: int) -> bool:
        """Whole-prompt bucketed prefill only: a prompt the engine admits
        in chunks serves plain decode."""
        return prompt_len <= self.prefill_buckets[-1]

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.prefill_buckets:
            if b >= prompt_len:
                return b
        raise ValueError(f"prompt length {prompt_len} exceeds the "
                         f"largest draft bucket "
                         f"({self.prefill_buckets[-1]})")

    def admit(self, slot: int, prompt0: np.ndarray) -> None:
        """Prefill the drafter for one admitted request: always the FULL
        prompt (its dense cache is private, no prefix chain to reuse)."""
        t = int(prompt0.shape[0])
        ids = np.zeros((1, self.bucket_for(t)), np.int64)
        ids[0, :t] = prompt0
        self.prefill_cache(self._params, self.model.buffers,
                           self._prefill_x(ids, t, slot))
        self._st[slot] = _DraftSlot(t)

    def push(self, slot: int, token0: int) -> None:
        """Queue an emitted token the drafter has not attended yet."""
        self._st[slot].pending.append(int(token0))

    def release(self, slot: int) -> None:
        self._st[slot] = None

    def release_all(self) -> None:
        self._st = [None] * self.slots

    # -- the draft round ------------------------------------------------ #
    def draft_round(self, jobs: Dict[int, tuple]) -> Dict[int, tuple]:
        """Draft ``k_eff`` tokens for each job.  ``jobs`` maps slot ->
        (k_eff, temperature, keys), or (k_eff, temperature, keys,
        alt_counts) in tree mode, where ``alt_counts[i]`` asks for that
        many ranked alternates off draft step i; ``keys`` is an optional
        (k_eff, 2) uint32 chain-key slice.  Every job first catches its
        slot up on pending tokens, then drafts autoregressively; all
        jobs advance in lockstep through the one batched decode step.
        Returns slot -> (drafts, draft logit rows (rejection mode only,
        else None), one ranked alternate list per draft step)."""
        if not jobs:
            return {}
        state: Dict[int, dict] = {}
        for s, job in jobs.items():
            k_eff, temp, keys = job[:3]
            alt_counts = tuple(job[3]) if len(job) > 3 else ()
            feeds = list(self._st[s].pending)
            if not feeds:
                raise RuntimeError(f"draft_round on slot {s}, which has "
                                   "no pending token")
            state[s] = {"feeds": feeds, "k": int(k_eff), "temp": temp,
                        "keys": keys, "drafts": [], "rows": [], "fed": 0,
                        "alts": [], "alt_counts": alt_counts,
                        "total": len(feeds) + int(k_eff) - 1}
        n_steps = max(v["total"] for v in state.values())
        keep_rows = self.sampling == "rejection"
        for _ in range(n_steps):
            token = np.zeros((self.slots,), np.int64)
            pos = np.full((self.slots,), self.scratch_pos, np.int64)
            stepped = []
            for s, v in state.items():
                if v["fed"] >= v["total"]:
                    continue
                nf = len(v["feeds"])
                token[s] = (v["feeds"][v["fed"]] if v["fed"] < nf
                            else v["drafts"][v["fed"] - nf])
                pos[s] = self._st[s].q_next + v["fed"]
                v["fed"] += 1
                stepped.append(s)
            logits = self._decode(token, pos)
            self.steps += 1
            for s in stepped:
                v = state[s]
                if v["fed"] >= len(v["feeds"]) and len(v["drafts"]) < v["k"]:
                    i = len(v["drafts"])
                    key = v["keys"][i] if v["keys"] is not None else None
                    v["drafts"].append(draft_pick(
                        logits[s], v["temp"], key, self.sampling))
                    if keep_rows:
                        v["rows"].append(logits[s].copy())
                    na = (v["alt_counts"][i]
                          if i < len(v["alt_counts"]) else 0)
                    v["alts"].append(_ranked_alternates(
                        logits[s], v["temp"], key, v["drafts"][-1], na)
                        if na > 0 else [])
        out = {}
        for s, v in state.items():
            st = self._st[s]
            st.draft_base = st.q_next + len(v["feeds"])
            st.q_next = st.draft_base + v["k"] - 1
            st.last_k = v["k"]
            st.pending = []
            out[s] = (v["drafts"], v["rows"] if keep_rows else None,
                      v["alts"])
        return out

    def commit(self, slot: int, accepted: int, emitted) -> None:
        """Reconcile one slot after verification: rewind ``q_next`` past
        the last valid drafter write (drafts are written only when fed,
        so at most ``k_eff - 1`` are in the cache) and queue the emitted
        tokens the drafter has not attended, always at least the
        bonus/correction token."""
        st = self._st[slot]
        valid = min(int(accepted), max(st.last_k - 1, 0))
        st.q_next = st.draft_base + valid
        st.pending = [int(t) for t in emitted[valid:]]

    # -- reading -------------------------------------------------------- #
    def describe(self) -> dict:
        return {"dtype_tag": self.dtype_tag,
                "compute_mode": self.compute_mode,
                "hidden": self.model.hidden_size,
                "layers": self.model.n_layers,
                "cache_len": self.cache_len,
                "arena_bytes": self.arena_bytes,
                "steps": self.steps,
                "decode_compiles": self.decode_compiles,
                "prefill_cache": self.prefill_cache.stats()}


class NgramDrafter:
    """Zero-model prompt-lookup drafter: proposals come from suffix
    n-gram matches against the request's OWN prompt + emitted tokens,
    the free win for outputs that quote their inputs.  Duck-types the
    ``DraftModel`` surface the engine drives, with no device work:
    ``steps`` stays 0.

    Correctness needs nothing from the heuristic: under replay
    acceptance a proposed token is accepted iff it equals the offline
    emission, so an unmatched filler never accepts.  Drafting is a pure
    function of the slot's history, and every ingested token is checked
    against the target vocab, so a corrupt id fails at admission."""

    def __init__(self, vocab_size: int, *, slots: int, ngram_max: int = 3):
        self.vocab_size = int(vocab_size)
        self.slots = int(slots)
        self.ngram_max = max(1, int(ngram_max))
        self._ctx: List[Optional[List[int]]] = [None] * self.slots
        self.steps = 0             # never advances: zero drafter cost
        self.decode_compiles = 0   # no device step, no graph
        self.compute_mode = "ngram"
        self.arena_bytes = 0
        self.lookups = 0
        self.hits = 0

    def warmup(self) -> int:
        return 0

    def can_draft(self, prompt_len: int) -> bool:
        # no prefill buckets: any prompt the engine admits is usable
        return True

    # -- per-slot lifecycle --------------------------------------------- #
    def _checked(self, toks) -> List[int]:
        out = []
        for t in np.asarray(toks, dtype=np.int64).reshape(-1).tolist():
            if not 0 <= t < self.vocab_size:
                raise ValueError(
                    f"ngram drafter fed token {t} outside the target "
                    f"vocab [0, {self.vocab_size})")
            out.append(int(t))
        return out

    def admit(self, slot: int, prompt0: np.ndarray) -> None:
        self._ctx[slot] = self._checked(prompt0)

    def push(self, slot: int, token0: int) -> None:
        self._ctx[slot].extend(self._checked([token0]))

    def commit(self, slot: int, accepted: int, emitted) -> None:
        # the drafter attends nothing: catching up is extending the
        # context with every emitted token
        del accepted
        self._ctx[slot].extend(self._checked(emitted))

    def release(self, slot: int) -> None:
        self._ctx[slot] = None

    def release_all(self) -> None:
        self._ctx = [None] * self.slots

    # -- drafting ------------------------------------------------------- #
    def _continuations(self, ctx: List[int], k: int,
                       want: int) -> List[List[int]]:
        """Ranked distinct continuations of the current suffix: longest
        matching n-gram first, most recent occurrence first."""
        out: List[List[int]] = []
        seen = set()
        n_ctx = len(ctx)
        for n in range(min(self.ngram_max, n_ctx - 1), 0, -1):
            pat = tuple(ctx[n_ctx - n:])
            for s in range(n_ctx - n - 1, -1, -1):
                if tuple(ctx[s:s + n]) == pat:
                    cont = ctx[s + n:s + n + k]
                    if cont and tuple(cont) not in seen:
                        seen.add(tuple(cont))
                        out.append(cont)
                        if len(out) >= want:
                            return out
        return out

    def draft_round(self, jobs: Dict[int, tuple]) -> Dict[int, tuple]:
        out = {}
        for s, job in jobs.items():
            k_eff = int(job[0])
            alt_counts = tuple(job[3]) if len(job) > 3 else ()
            ctx = self._ctx[s][-_NGRAM_WINDOW:]
            self.lookups += 1
            want = 1 + (max(alt_counts) if alt_counts else 0)
            conts = self._continuations(ctx, k_eff, want)
            if conts:
                self.hits += 1
            # spine: the best continuation, padded with the last context
            # token (a wrong filler costs nothing under replay)
            filler = ctx[-1]
            spine = list(conts[0]) if conts else []
            spine += [filler] * (k_eff - len(spine))
            alts: List[List[int]] = []
            for i in range(k_eff):
                na = alt_counts[i] if i < len(alt_counts) else 0
                ranked: List[int] = []
                for c in conts[1:]:
                    if len(ranked) >= na:
                        break
                    if i < len(c) and c[i] != spine[i] \
                            and c[i] not in ranked:
                        ranked.append(c[i])
                alts.append(ranked)
            out[s] = (spine, None, alts)
        return out

    def describe(self) -> dict:
        return {"compute_mode": self.compute_mode,
                "ngram_max": self.ngram_max,
                "steps": self.steps,
                "lookups": self.lookups,
                "hit_rate": (self.hits / self.lookups
                             if self.lookups else 0.0)}
