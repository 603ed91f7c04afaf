"""A training cell: ``bigdl_tpu_torch``'s ``LocalOptimizer`` stepping a
``TransformerLM`` on seeded token rows, timed over whole steps.

Set-up builds the model from the seed's weights and one optimizer (Adam,
``TimeDistributedCriterion(ClassNLLCriterion)``), and drives that same
object through its first ``check_steps`` steps with ``optimize()``, the
call and the feed the window uses.  A trigger, which the loop consults
before every step, reads what the check compares as the steps go: each
step's loss, every leaf's gradient as Adam received it (its first moment
after step 1, over 1 - beta1), and every leaf's change after the last
checked step, before the next one writes it.  Those steps also load the
kernels and fill the allocator, so the window's steps find everything
made.  The window calls ``optimize()`` again on the same object; a
trigger ends it at the first step boundary past ``--seconds``, so the
window is whole steps and its rate is all tokens over all the time.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from h100_bench.bench.common import log, median, scratch_dir
from h100_bench.bench.devtrace import DeviceTrace, warm_profiler
from h100_bench.bench.weights import leaves, make_params, sizes
from h100_bench.reference import gpt2


class Feed:
    """The optimizer's dataset: step ``k`` (from 0) gets the rows the
    cell's traffic kind draws for it; the feed never rolls over."""

    def __init__(self, cell, seed: int, vocab: int):
        self.kind, self.traffic = cell.traffic_kind(), cell.traffic
        self.seed, self.vocab = seed, vocab
        self.next_step = 0

    def rows(self, step: int):
        return self.kind.batch(self.traffic, self.seed, step, self.vocab)

    def size(self) -> int:
        return 1 << 40

    def shuffle(self) -> None:
        pass

    def data(self, train: bool):
        from bigdl_tpu_torch.dataset.types import MiniBatch
        while True:
            x, y = self.rows(self.next_step)
            self.next_step += 1
            yield MiniBatch(x, y)


def leaf_norms(tree) -> Dict[str, float]:
    return {name: float(torch.linalg.vector_norm(t.float()))
            for name, t in leaves(tree)}


class TrainRun:
    """One run of a training cell: :meth:`setup`, :meth:`window_run`,
    :meth:`free` and :meth:`verify`, in that order."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device="cuda", t_start: Optional[float] = None):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.s = sizes(cell.config)
        self.settings = cell.settings
        self.batch = int(cell.traffic["batch"])
        self.seq_len = int(cell.traffic["seq_len"])
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.steps_window = 0
        self.step_ends: List[float] = []
        self.devtrace: Optional[DeviceTrace] = None
        self.check: Dict[str, dict] = {}
        self.correct = False
        self.memory_peak = 0
        self.readings: Dict[str, float] = {}
        self.control: Optional[dict] = None

    # -- set-up ------------------------------------------------------- #
    def setup(self):
        from bigdl_tpu_torch.models.transformer import TransformerLM
        from bigdl_tpu_torch.nn import (ClassNLLCriterion,
                                        TimeDistributedCriterion)
        from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger
        gpt2.strict_float32()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
            if self.trace:
                warm_profiler()
        s = self.s
        self.model = TransformerLM(
            vocab_size=s["vocab"], hidden_size=s["hidden"],
            n_head=s["heads"], n_layers=s["layers"], ffn_size=s["ffn"],
            max_len=s["positions"], dropout=0.0, tie_embeddings=True,
            attention_impl="auto", device=self.device)
        self.model.params = make_params(self.cell.config, self.seed,
                                        self.device)
        opt_kw = self.settings["adam"]
        self.adam = Adam(learning_rate=opt_kw["lr"], beta1=opt_kw["beta1"],
                         beta2=opt_kw["beta2"], eps=opt_kw["eps"])
        self.feed = Feed(self.cell, self.seed, s["vocab"])
        self.opt = LocalOptimizer(
            self.model, self.feed,
            TimeDistributedCriterion(ClassNLLCriterion(), True))
        self.opt.set_optim_method(self.adam)
        n_check = int(self.settings["check_steps"])
        start = {name: t.detach().clone()
                 for name, t in leaves(self.model.params)}
        got = {"losses": [], "grad_norms": None, "change_norms": None}
        beta1 = self.adam.beta1

        def checkpoint(state) -> bool:
            done = state["neval"] - 1          # steps completed
            if done >= 1 and len(got["losses"]) < done:
                got["losses"].append(float(state["loss"]))
            if done == 1:
                m = self.adam._state["m"]
                got["grad_norms"] = {k: v / (1 - beta1)
                                     for k, v in leaf_norms(m).items()}
            if done == n_check:
                got["change_norms"] = {
                    name: float(torch.linalg.vector_norm(t - start[name]))
                    for name, t in leaves(self.model.params)}
                return True
            return False

        self.opt.set_end_when(Trigger(checkpoint, "h100_bench_check"))
        self.opt.optimize()
        del start
        self.program = got
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log(f"[train] set-up steps: losses {got['losses']}")

    # -- the window --------------------------------------------------- #
    def window_run(self):
        from bigdl_tpu_torch.optim import Trigger
        span = int(self.settings.get("profile_steps", 3))
        ends = self.step_ends
        prof_at = None
        if self.trace and self.device.type == "cuda":
            self.devtrace = DeviceTrace(str(scratch_dir("train")))
        t0 = time.perf_counter()
        self.setup_s = t0 - self.t_start
        first = self.opt.state["neval"]

        def until(state) -> bool:
            nonlocal prof_at
            now = time.perf_counter()
            k = state["neval"] - first        # steps done in the window
            if k:
                ends.append(now)
            if self.devtrace is not None:
                if prof_at is None and now - t0 >= 0.5 * self.seconds:
                    prof_at = k
                    self.devtrace.start()
                elif prof_at is not None and k == prof_at + span:
                    self.devtrace.stop()
                elif prof_at is not None and self.devtrace.t1 is None:
                    self.devtrace.mark("step")
            done = now - t0 >= self.seconds
            if done and self.devtrace is not None and prof_at is not None \
                    and self.devtrace.t1 is None:
                self.devtrace.stop()
            return done

        self.opt.set_end_when(Trigger(until, "h100_bench_window"))
        self.opt.optimize()
        self.steps_window = len(ends)
        self.window = (t0, ends[-1] if ends else time.perf_counter())
        if self.devtrace is not None and self.devtrace.t1 is not None:
            self.devtrace.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))

    def tokens_per_step(self) -> int:
        return self.batch * self.seq_len

    def end_to_end(self) -> Dict[str, float]:
        t0, t1 = self.window
        return {"train_tokens_per_s":
                self.steps_window * self.tokens_per_step() / (t1 - t0),
                "setup_s": self.setup_s}

    def attempted(self) -> int:
        return self.steps_window

    def failed(self) -> int:
        return 0

    # -- correctness -------------------------------------------------- #
    def free(self) -> None:
        self.opt = None
        self.model = None
        self.adam = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32",
                  rows: Optional[int] = None) -> dict:
        """The reference's readings of the checked steps, from the seed's
        weights and the same rows (the first ``rows`` of each batch when
        given: the fault of a step that leaves half its batch out)."""
        gpt2.strict_float32()
        params = make_params(self.cell.config, self.seed, self.device)
        n = int(self.settings["check_steps"])
        batches = []
        feed = Feed(self.cell, self.seed, self.s["vocab"])
        for k in range(n):
            x, y = feed.rows(k)
            x, y = x[:rows], y[:rows]
            batches.append((torch.as_tensor(x - 1, device=self.device),
                            torch.as_tensor(y - 1, device=self.device)))
        a = self.settings["adam"]
        out = gpt2.adam_steps(params, batches, self.s["heads"],
                              self.s["eps"], lr=a["lr"], beta1=a["beta1"],
                              beta2=a["beta2"], adam_eps=a["eps"],
                              row_block=int(self.settings["reference_rows"]),
                              precision=precision)
        ref = {"losses": out["losses"],
               "grad_norms": leaf_norms(out["first_grads"]),
               "change_norms": {
                   name: float(torch.linalg.vector_norm(t - out["start"][name]))
                   for name, t in leaves(params)}}
        del params, out
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return ref

    def verify(self, control: bool = False) -> None:
        t = time.perf_counter()
        ref = self.reference()
        self.reference_s = time.perf_counter() - t
        self.readings = compare(self.program, ref)
        lim = self.settings["check"]
        self.check = {k: {"value": self.readings[k], "limit": lim[k]}
                      for k in ("loss_rel_gap", "grad_norm_gap",
                                "change_norm_gap")}
        self.check["leaves_left_out"] = {
            "value": self.readings["leaves_left_out"], "limit": None}
        log(f"[train] worst leaves: gradient "
            f"{self.readings['grad_norm_leaf']}, change "
            f"{self.readings['change_norm_leaf']}")
        self.correct = all(self.check[k]["value"] <= self.check[k]["limit"]
                           for k in ("loss_rel_gap", "grad_norm_gap",
                                     "change_norm_gap"))
        if control:
            self.control = {
                "tf32": compare(self.reference(precision="tf32"), ref),
                "half_batch": compare(
                    self.reference(rows=self.batch // 2), ref)}

    def context(self) -> dict:
        return {"kind": "train", "run": self, "sizes": self.s,
                "devtrace": self.devtrace, "window": self.window}

    def breakdown(self) -> Optional[dict]:
        if self.devtrace is None or self.devtrace.t1 is None:
            return None
        return self.devtrace.breakdown()


def compare(program: dict, ref: dict) -> Dict[str, float]:
    """The numbers the check compares, each a gap against the reference:

    - ``loss_rel_gap``: the largest relative gap of a checked step's loss;
    - ``grad_norm_gap`` and ``change_norm_gap``: over the leaves, the
      largest gap between the program's norm and the reference's, over
      the larger of the reference's norm of that leaf and of the median
      leaf.  Leaves whose reference gradient is under a thousandth of
      the median leaf's (nought but rounding, as a key's bias is under
      softmax) are left out of the change, by that rule and not by
      name."""
    losses = [abs(a - b) / abs(b)
              for a, b in zip(program["losses"], ref["losses"])]
    if len(program["losses"]) != len(ref["losses"]):
        losses.append(float("inf"))

    def worst(p: Dict[str, float], r: Dict[str, float], keep):
        med = median([r[k] for k in keep]) if keep else 0.0
        gaps = {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in keep}
        if not gaps:
            return float("inf"), None
        leaf = max(gaps, key=gaps.get)
        return gaps[leaf], leaf

    g_ref = ref["grad_norms"]
    med_g = median(list(g_ref.values()))
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * med_g]
    grad, grad_leaf = worst(program["grad_norms"], g_ref, list(g_ref))
    change, change_leaf = worst(program["change_norms"],
                                ref["change_norms"], moved)
    return {"loss_rel_gap": max(losses) if losses else float("inf"),
            "grad_norm_gap": grad, "change_norm_gap": change,
            "leaves_left_out": len(g_ref) - len(moved),
            "grad_norm_leaf": grad_leaf, "change_norm_leaf": change_leaf}


Run = TrainRun


def run_cell(cell, seed, seconds, trace, device="cuda", t_start=None):
    run = TrainRun(cell, seed, seconds, trace, device=device,
                   t_start=t_start)
    run.setup()
    run.window_run()
    run.free()
    run.verify()
    return run
