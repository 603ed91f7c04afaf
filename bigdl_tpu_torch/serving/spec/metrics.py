"""Speculation counters, published as ``serving/lm/spec/*`` (port of
``bigdl_tpu/serving/spec/metrics.py``).

Thread-safe: the engine's worker records, ``stats()`` and the registry
read.  The two derived rates are the subsystem's health summary:
``acceptance_rate`` (accepted drafts over drafted) and
``draft_overhead`` (drafter decode steps per emitted token).
``fault_demotions`` counts the slots an injected transient at the
``serving.verify`` fault site demoted to plain decode."""
from __future__ import annotations

import threading

from bigdl_tpu_torch.obs.registry import FnGauge, Histogram


class SpecMetrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.drafted = 0          # draft tokens proposed to verify
        self.accepted = 0         # drafts the target agreed with
        self.rolled_back = 0      # drafts rejected (pointer rewinds)
        self.draft_steps = 0      # drafter decode steps executed
        self.verify_rounds = 0    # verify steps (incl. all-plain)
        self.spec_rounds = 0      # verify steps with >= 1 speculating slot
        self.emitted = 0          # tokens emitted by the spec engine
        self.demotions = 0        # EMA-collapse demotions
        self.fault_demotions = 0  # injected-transient demotions
        self.reprobes = 0         # demoted slots re-probed
        self.compute_mode = "f32"  # the drafter's regime, set by the engine
        self.overflow_risk = 0.0  # the drafter's quant_report, by the engine
        self.acceptance = Histogram()  # per-(slot, round) acceptance rate
        self.tree_rounds = 0      # (slot, round) pairs verified as a tree
        self.alt_accepts = 0      # accepted ALTERNATE (off-spine) nodes
        self.tree_depth = Histogram()    # chosen shape max_depth per slot
        self.tree_width = Histogram()    # chosen shape width per slot
        self.accepted_per_step = Histogram()  # tokens emitted per
        #                                       (slot, verify round)

    def publish_to(self, registry,
                   prefix: str = "serving/lm/spec/") -> "SpecMetrics":
        for key in ("drafted", "accepted", "rolled_back", "draft_steps",
                    "verify_rounds", "spec_rounds", "emitted", "demotions",
                    "fault_demotions", "reprobes", "tree_rounds",
                    "alt_accepts"):
            registry.register(prefix + key,
                              FnGauge(lambda k=key: getattr(self, k)),
                              replace=True)
        for key, snap_key in (("accept_rate", "acceptance_rate"),
                              ("draft_overhead", "draft_overhead"),
                              ("accepted_per_verify_step",
                               "accepted_per_verify_step")):
            registry.register(
                prefix + key,
                FnGauge(lambda k=snap_key: self.snapshot()[k]),
                replace=True)
        for key in ("acceptance", "tree_depth", "tree_width",
                    "accepted_per_step"):
            registry.register(prefix + key, getattr(self, key),
                              replace=True)
        registry.register(prefix + "compute_mode",
                          FnGauge(lambda: self.compute_mode), replace=True)
        registry.register(prefix + "overflow_risk",
                          FnGauge(lambda: self.overflow_risk), replace=True)
        return self

    # -- recording ------------------------------------------------------ #
    def record_round(self, drafted: int, accepted: int) -> None:
        """One slot's verify-round outcome: ``drafted`` proposals, the
        leading ``accepted`` of them matched."""
        with self._lock:
            self.drafted += drafted
            self.accepted += accepted
            self.rolled_back += drafted - accepted
            if drafted:
                self.acceptance.observe(accepted / drafted)

    def record_verify_round(self, speculated: bool, emitted: int,
                            draft_steps: int) -> None:
        with self._lock:
            self.verify_rounds += 1
            if speculated:
                self.spec_rounds += 1
            self.emitted += emitted
            self.draft_steps += draft_steps

    def record_tree_slot(self, depth: int, width: int,
                         emitted: int, alt_accepted: int) -> None:
        """One slot's tree-round choice (the shape's max depth and width)
        and outcome (tokens emitted, off-spine nodes accepted)."""
        with self._lock:
            self.tree_rounds += 1
            self.alt_accepts += alt_accepted
            self.tree_depth.observe(depth)
            self.tree_width.observe(width)
            self.accepted_per_step.observe(emitted)

    def record_demotion(self, fault: bool = False) -> None:
        with self._lock:
            self.demotions += 1
            if fault:
                self.fault_demotions += 1

    def record_reprobe(self) -> None:
        with self._lock:
            self.reprobes += 1

    # -- reading -------------------------------------------------------- #
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "drafted": self.drafted,
                "accepted": self.accepted,
                "rolled_back": self.rolled_back,
                "draft_steps": self.draft_steps,
                "verify_rounds": self.verify_rounds,
                "spec_rounds": self.spec_rounds,
                "emitted": self.emitted,
                "demotions": self.demotions,
                "fault_demotions": self.fault_demotions,
                "reprobes": self.reprobes,
                "compute_mode": self.compute_mode,
                "overflow_risk": self.overflow_risk,
                "acceptance_rate":
                    (self.accepted / self.drafted) if self.drafted else None,
                "draft_overhead":
                    (self.draft_steps / self.emitted)
                    if self.emitted else None,
                "accepted_per_verify_step":
                    (self.emitted / self.verify_rounds)
                    if self.verify_rounds else None,
                "tree_rounds": self.tree_rounds,
                "alt_accepts": self.alt_accepts,
                "acceptance": self.acceptance.snapshot(),
                "tree_depth": self.tree_depth.snapshot(),
                "tree_width": self.tree_width.snapshot(),
                "accepted_per_step": self.accepted_per_step.snapshot(),
            }
