"""PlacementPolicy: pack replicas onto slots, report headroom (port of
``bigdl_tpu/serving/placement/policy.py``).

A replica set asks the policy for a slot per replica (acquire) and hands
slots back when replicas drain (release); ``headroom()`` is the scale-up
gate the SLO controller consults before growing, the contract of the
engine's ``kvcache_headroom``: a falsy answer makes the ladder fall
through to admission tightening instead of oversubscribing devices.

Slots are **phase-taggable**: disaggregated serving acquires a slot
*as* a prefill or decode replica (``acquire(phase=...)``), so the policy
reports per-phase occupancy (``serving/placement/phase/*`` gauges) and
the DisaggCoordinator's two SLO ladders each see how much of the device
set their phase holds.  Any free slot can serve any phase (the tag
records intent, it does not partition the hardware), so ``headroom()``
stays one number.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from bigdl_tpu_torch.serving.placement.slicer import (MeshSlice,
                                                      MeshSlicer,
                                                      PlacementError)
from bigdl_tpu_torch.serving.placement.topology import DeviceTopology


class PlacementPolicy:
    """Carve once, then hand out slots first-fit.

    Args:
        topology: device set to carve (default: ``DeviceTopology.detect()``,
            collective when a process world runs: every rank builds the
            policy).
        slots: number of replica slots; default ``max_slots(tp)`` — use
            everything the backend has.
        tp: tensor-parallel degree within each slot.
    """

    def __init__(self, topology: Optional[DeviceTopology] = None, *,
                 slots: Optional[int] = None, tp: int = 1):
        slicer = MeshSlicer(topology)
        if slots is None:
            slots = max(1, slicer.max_slots(tp))
        self.tp = int(tp)
        self._slices: List[MeshSlice] = slicer.carve(slots, tp)
        self._free: List[MeshSlice] = list(self._slices)
        self._phase: Dict[int, str] = {}   # slot_id -> phase tag
        self._seen_phases: set = set()     # gauges zero out on release
        self._lock = threading.Lock()
        self._publish()

    # -- slot lifecycle -------------------------------------------------

    def acquire(self, phase: Optional[str] = None) -> Optional[MeshSlice]:
        """Lowest-id free slot, or None when the device set is full.
        ``phase`` tags the slot for the duration of the lease (e.g.
        ``"prefill"`` / ``"decode"`` from the DisaggCoordinator) so
        per-phase occupancy is observable; untagged acquires keep the
        original contract."""
        with self._lock:
            if not self._free:
                return None
            s = self._free.pop(0)
            if phase is not None:
                self._phase[s.slot_id] = str(phase)
                self._seen_phases.add(str(phase))
        self._publish()
        return s

    def release(self, s: MeshSlice) -> None:
        with self._lock:
            if s not in self._slices:
                raise PlacementError(f"{s!r} was not carved by this policy")
            if s in self._free:
                raise PlacementError(f"{s!r} released twice")
            self._free.append(s)
            self._free.sort(key=lambda m: m.slot_id)
            self._phase.pop(s.slot_id, None)
        self._publish()

    def phase_of(self, s: MeshSlice) -> Optional[str]:
        """The phase tag a held slot was acquired under (None when
        untagged or free)."""
        with self._lock:
            return self._phase.get(s.slot_id)

    def phase_counts(self) -> Dict[str, int]:
        """Held slots per phase tag (untagged leases count under
        ``"untagged"``)."""
        with self._lock:
            held = [s for s in self._slices if s not in self._free]
            out: Dict[str, int] = {}
            for s in held:
                key = self._phase.get(s.slot_id, "untagged")
                out[key] = out.get(key, 0) + 1
            return out

    # -- accounting -----------------------------------------------------

    @property
    def slices(self) -> tuple:
        """Every slot of the carve, held or free, by slot id."""
        return tuple(self._slices)

    @property
    def slots_total(self) -> int:
        return len(self._slices)

    def headroom(self) -> int:
        """Free slots — 0 means scale-up must be refused."""
        with self._lock:
            return len(self._free)

    def stats(self) -> dict:
        with self._lock:
            free = len(self._free)
            slots = []
            for s in self._slices:
                d = s.describe()
                d["phase"] = self._phase.get(s.slot_id)
                slots.append(d)
        return {
            "slots_total": self.slots_total,
            "slots_used": self.slots_total - free,
            "slots_free": free,
            "devices_per_slot": self.tp,
            "phase_counts": self.phase_counts(),
            "slots": slots,
        }

    def _publish(self) -> None:
        from bigdl_tpu_torch.obs import get_registry
        reg = get_registry()
        with self._lock:
            free = len(self._free)
        reg.gauge("serving/placement/slots_total").set(self.slots_total)
        reg.gauge("serving/placement/slots_used").set(self.slots_total - free)
        reg.gauge("serving/placement/devices_per_slot").set(self.tp)
        counts = self.phase_counts()
        with self._lock:
            phases = set(self._seen_phases)
        for phase in phases:
            reg.gauge(f"serving/placement/phase/{phase}").set(
                counts.get(phase, 0))

    def __repr__(self) -> str:
        return (f"PlacementPolicy({self.slots_total} slots x TP{self.tp}, "
                f"{self.headroom()} free)")
