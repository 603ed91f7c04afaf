"""A serving cell: ``bigdl_tpu_torch``'s ``LMServingEngine`` under an
open-loop schedule, timed on the client's clock.

Set-up builds the model from the seed's weights, the engine with the
cell's settings, and makes every graph the cell's traffic uses
(``warmup()``, and ``warmup_prefix()`` for the (suffix, cached prefix)
pairs the schedule's later asks meet).  The window then submits each
request at its due time from one generator thread, and stamps every
token on the host clock as the engine hands it to the request's stream
(the stream's observer hook), so that no reader thread a request
competes with the engine's worker for the interpreter.  Requests are
timed from when they were due; the generator's own lateness is kept
apart.  After the last due time the run waits for every stream to end,
closes the engine, reads the peak memory, frees the program's state,
and holds a seeded sample of the finished greedy requests against the
plain reference.
"""
from __future__ import annotations

import collections
import gc
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from h100_bench.bench import loadgen, reads
from h100_bench.bench.common import log, percentile, scratch_dir
from h100_bench.bench.devtrace import DeviceTrace, warm_profiler
from h100_bench.bench.weights import make_params, sizes
from h100_bench.reference import gpt2

#: the harness's instant in the tracer's ring, at a known host time
EPOCH_MARK = "h100_bench/epoch"


class Record:
    """One request as the client saw it."""

    __slots__ = ("req", "due", "submitted", "times", "tokens", "error",
                 "stream", "ended", "shed")

    def __init__(self, req: loadgen.Request, due: float):
        self.req = req
        self.due = due            # host time the request was due
        self.submitted = None
        self.times: List[float] = []
        self.tokens: List[int] = []
        self.error: Optional[BaseException] = None
        self.stream = None
        self.ended = threading.Event()
        self.shed = False

    @property
    def finished(self) -> bool:
        return (self.error is None and not self.shed
                and len(self.tokens) == self.req.max_new)


def _observer(rec: Record):
    """The stream's observer for ``rec``: called by the engine's worker,
    under the stream's lock, with each token as it lands and then the
    end; it stamps and keeps, and never blocks."""
    def seen(what, *args):
        if what == "tok":
            rec.times.append(time.perf_counter())
            rec.tokens.append(int(args[0]))
        else:
            rec.error = args[1]
            rec.ended.set()
    return seen


def build_model(config: dict, params: dict, device):
    from bigdl_tpu_torch.models.transformer import TransformerLM
    s = sizes(config)
    model = TransformerLM(
        vocab_size=s["vocab"], hidden_size=s["hidden"], n_head=s["heads"],
        n_layers=s["layers"], ffn_size=s["ffn"], max_len=s["positions"],
        dropout=0.0, tie_embeddings=True, attention_impl="auto",
        device=device)
    model.params = params
    return model


def prefix_pairs(requests, block_len: int):
    """The (unmatched suffix, cached prefix blocks) of every later ask
    of a session: the prefix-prefill entries the traffic meets."""
    suffix, blocks = [], []
    for r in requests:
        if r.ask and r.prefix_len >= block_len:
            nb = r.prefix_len // block_len
            suffix.append(len(r.prompt) - nb * block_len)
            blocks.append(nb)
    return suffix, blocks


class ServeRun:
    """One run of a serving cell: :meth:`setup`, :meth:`window_run`,
    :meth:`free` and :meth:`verify`, in that order."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device="cuda", rate_rps: Optional[float] = None,
                 t_start: Optional[float] = None):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.s = sizes(cell.config)
        self.settings = cell.settings
        self.rate = rate_rps
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.records: List[Record] = []
        self.events: list = []
        self.devtrace: Optional[DeviceTrace] = None
        self.stats_before: dict = {}
        self.stats_after: dict = {}
        self.setup_s = None
        self.window = None
        self.memory_peak = 0
        self.check: Dict[str, dict] = {}
        self.correct = False
        self.control: Optional[dict] = None
        self.tracer_epoch = 0.0
        self.reference_s = None

    # -- set-up ------------------------------------------------------- #
    def schedule(self, seed: int, seconds: float,
                 rate_rps: Optional[float]) -> List[loadgen.Request]:
        """The requests the cell's mix sends in a window, by its kind."""
        return self.cell.traffic_kind().schedule(
            self.cell.traffic, seed, seconds, self.s["vocab"],
            rate_rps=rate_rps, root=self.cell.root)

    def setup(self):
        from bigdl_tpu_torch.serving.lm_engine import LMServingEngine
        eng_kw = dict(self.settings["engine"])
        self.requests = self.schedule(self.seed, self.seconds, self.rate)
        loadgen.check_lengths(self.requests, eng_kw["cache_len"])
        log(f"[serve] schedule {loadgen.describe(self.requests)}")
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
            if self.trace:
                warm_profiler()
        params = make_params(self.cell.config, self.seed, self.device)
        self.model = build_model(self.cell.config, params, self.device)
        self.engine = LMServingEngine(self.model, device=self.device,
                                      **eng_kw)
        made = self.engine.warmup()
        suffix, blocks = prefix_pairs(self.requests,
                                      self.engine.block_len)
        made_prefix = (self.engine.warmup_prefix(suffix, blocks)
                       if suffix else 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats_before = self.engine.stats()
        log(f"[serve] warm: {made} prefill and {made_prefix} prefix-prefill "
            f"entries, graphs {self.stats_before['cuda_graphs']}")

    # -- the window --------------------------------------------------- #
    def _profile(self, t0: float) -> None:
        """The device trace over a steady slice near the window's end.
        The profiler is driven from the main thread (it registers there),
        while the generator submits from its own thread; a burst of
        marks every 0.07-0.12 s ties the trace's clock to the host's."""
        span = float(self.settings.get("profile_seconds", 3.0))
        start = t0 + max(0.5 * self.seconds, self.seconds - 1.0 - span)
        time.sleep(max(0.0, start - time.perf_counter()))
        self.devtrace.start()
        k = 0
        while time.perf_counter() < start + span:
            # uneven spacing: only the true offset lines the marks up;
            # a burst of marks a tick, of which the tightest is used
            time.sleep(0.07 + 0.013 * (k % 5))
            self.devtrace.mark("tick", 8)
            k += 1
        self.devtrace.stop()

    def _generate(self) -> None:
        """Submit each request at its due time and watch its stream."""
        from bigdl_tpu_torch.serving.errors import ServingQueueFull
        for rec in self.records:
            wait = rec.due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            rec.submitted = time.perf_counter()
            try:
                rec.stream = self.engine.submit(
                    rec.req.prompt, max_new_tokens=rec.req.max_new,
                    temperature=rec.req.temperature, rng=rec.req.rng)
            except ServingQueueFull as e:
                rec.shed, rec.error = True, e
                rec.ended.set()
                continue
            except Exception as e:  # noqa: BLE001 - a refused request
                rec.error = e
                rec.ended.set()
                continue
            rec.stream._observe(_observer(rec))

    def window_run(self, close_engine: bool = True):
        from bigdl_tpu_torch.obs import get_tracer
        tracer = get_tracer()
        if self.trace:
            tracer.clear()
            # the ring holds every span of the window
            tracer._events = collections.deque(maxlen=4_000_000)
            tracer.set_sample_rate(1.0)
            tracer.enable()
            mark_t = time.perf_counter()
            tracer.instant(EPOCH_MARK, cat="h100_bench")
            if self.device.type == "cuda":
                # device activity only: the engine's threads run on while
                # the profiler starts and stops
                self.devtrace = DeviceTrace(str(scratch_dir("serve")),
                                            host_ops=False)
        drain = float(self.settings.get("drain_limit_s", 60.0))
        t0 = time.perf_counter()
        self.setup_s = t0 - self.t_start
        close = t0 + self.seconds
        self.records = [Record(req, t0 + req.due_s) for req in self.requests]
        gen = threading.Thread(target=self._generate, daemon=True)
        gen.start()
        if self.devtrace is not None:
            self._profile(t0)
        gen.join()
        time.sleep(max(0.0, close - time.perf_counter()))
        for rec in self.records:
            rec.ended.wait(max(0.0, close + drain - time.perf_counter()))
        self.window = (t0, close)
        if self.devtrace is not None:
            self.devtrace.collect()
        self.stats_after = self.engine.stats()
        if close_engine:
            self.engine.close(timeout=10.0)
        if self.trace:
            tracer.disable()
            self.events = tracer.events()
            tracer.clear()
            mark = [e for e in self.events if e.get("name") == EPOCH_MARK]
            self.tracer_epoch = mark_t - mark[0]["ts"] / 1e6
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))

    # -- end-to-end readings ------------------------------------------ #
    def attempted(self) -> int:
        return len(self.records)

    def failed(self) -> int:
        return sum(1 for r in self.records if not r.finished)

    def ttfts_ms(self) -> List[float]:
        """TTFT of every request from its due time; a request with no
        first token counts as the whole wait."""
        t0, close = self.window
        drain = float(self.settings.get("drain_limit_s", 60.0))
        out = []
        for r in self.records:
            if r.times and not r.shed:
                out.append((r.times[0] - r.due) * 1e3)
            else:
                out.append((close + drain - r.due) * 1e3)
        return out

    def itls_ms(self) -> List[float]:
        out = []
        for r in self.records:
            out.extend((b - a) * 1e3 for a, b in zip(r.times, r.times[1:]))
        return out

    def end_to_end(self) -> Dict[str, float]:
        itl = self.itls_ms()
        return {"ttft_p95_ms": percentile(self.ttfts_ms(), 95.0),
                "itl_p95_ms": percentile(itl, 95.0) if itl else None,
                "setup_s": self.setup_s}

    # -- correctness -------------------------------------------------- #
    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.engine = None
        self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> List[Record]:
        """A seeded sample of the finished greedy requests, the longest
        first, until it holds ``check.served_tokens`` served tokens."""
        done = [r for r in self.records if r.finished and r.req.greedy]
        if not done:
            return []
        longest = max(done, key=lambda r: (len(r.req.prompt)
                                           + len(r.tokens), -r.req.index))
        rest = [r for r in done if r is not longest]
        order = np.random.default_rng(
            np.random.SeedSequence([self.seed % (2 ** 64), 4])
        ).permutation(len(rest))
        out, served = [longest], len(longest.tokens)
        want = int(self.settings["check"]["served_tokens"])
        for i in order:
            if served >= want:
                break
            out.append(rest[int(i)])
            served += len(rest[int(i)].tokens)
        return out

    def verify(self, control: bool = False) -> None:
        """Hold the sample against the reference: the widest gap by which
        a served token's logit lies below the reference's best.  With
        ``control``, the same check of the control in the program's
        place (``self.control``): at the same served positions of the
        same prompts and tokens, the token that the reference computed
        in TF32 puts first."""
        gpt2.strict_float32()
        params = make_params(self.cell.config, self.seed, self.device)
        worst = 0.0
        worst_ctrl = 0.0
        n_tok = 0
        sample = self.sample()
        t = time.perf_counter()
        for rec in sample:
            prompt0 = [int(x) - 1 for x in rec.req.prompt]
            served0 = [int(x) - 1 for x in rec.tokens]
            seq0 = prompt0 + served0[:-1]
            at = len(prompt0) - 1
            ref = gpt2.sequence_logits(params, seq0, self.s["heads"],
                                       self.s["eps"])[at:]
            worst = max(worst, float(gpt2.gaps(ref, served0).max()))
            n_tok += len(served0)
            if control:
                ctl = gpt2.sequence_logits(params, seq0, self.s["heads"],
                                           self.s["eps"],
                                           precision="tf32")[at:]
                worst_ctrl = max(worst_ctrl, float(gpt2.gaps(
                    ref, ctl.argmax(dim=-1)).max()))
                del ctl
            del ref
        self.reference_s = time.perf_counter() - t
        self.check, self.correct = self.judge(worst, len(sample), n_tok)
        if control:
            check, correct = self.judge(worst_ctrl, len(sample), n_tok)
            self.control = {"correct": correct,
                            "served_logit_gap": worst_ctrl,
                            "positions": n_tok}
        del params
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, worst: float, n_req: int, n_tok: int):
        """The check's numbers beside their limits, and whether they
        pass, for a widest served gap ``worst`` over ``n_req`` requests
        of ``n_tok`` tokens."""
        limit = float(self.settings["check"]["max_gap"])
        lost = sum(1 for r in self.records
                   if not r.shed and r.error is None and not r.finished)
        errored = sum(1 for r in self.records
                      if r.error is not None and not r.shed)
        check = {
            "served_logit_gap": {"value": worst, "limit": limit},
            "requests_compared": {"value": n_req, "limit": 1},
            "tokens_compared": {"value": n_tok, "limit": 1},
            "requests_unfinished": {"value": lost + errored, "limit": 0},
        }
        return check, (n_req > 0 and worst <= limit
                       and lost + errored == 0)

    # -- per-layer context -------------------------------------------- #
    def context(self) -> dict:
        return {"kind": "serve", "run": self, "sizes": self.s,
                "records": self.records, "events": self.events,
                "devtrace": self.devtrace, "window": self.window,
                "stats_before": self.stats_before,
                "stats_after": self.stats_after}

    def breakdown(self) -> Optional[dict]:
        if self.devtrace is None:
            return None
        ctx = self.context()
        return self.devtrace.breakdown(
            [(name, a, b) for name in ("lm/prefill", "lm/decode_step")
             for a, b, _ in reads.spans(ctx, name)])


Run = ServeRun


def run_cell(cell, seed, seconds, trace, device="cuda", t_start=None):
    run = ServeRun(cell, seed, seconds, trace, device=device,
                   t_start=t_start)
    run.setup()
    run.window_run()
    run.free()
    run.verify()
    return run
