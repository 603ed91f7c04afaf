"""DeviceTopology: the device set a placement carves (port of
``bigdl_tpu/serving/placement/topology.py``).

The reference asks the JAX backend for its devices.  The port serves
from two kinds of device set:

- no process world running: this process's cards, ``cuda:0`` to
  ``cuda:n-1``.  No card means an empty set, never the host in its
  place: ``detect("cpu")`` is how a caller asks for the host;
- a process world running (``parallel.init_world``): one device per
  rank, the rank's own, gathered from every rank with
  ``all_gather_object`` (so ``detect`` is then collective: every rank
  calls it).

A device's id is its position in the set: the card's index, or the
rank.  An explicit list (tests pass ``[torch.device("cpu")] * 8``, the
reference's eight virtual CPU devices) has ids by position as well.
Detection never raises: a device query that fails gives an empty
``degraded`` topology, which any carve then refuses loudly.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _kind(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev.index or 0)
    return dev.type


def world_rank() -> Optional[int]:
    """This process's rank in the running process world; None without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return None


def _probe(platform: Optional[str]):
    """(devices, kinds, per_rank) of the live device set."""
    if platform not in (None, "cuda", "cpu"):
        raise ValueError(f"platform must be 'cuda' or 'cpu', got "
                         f"{platform!r}")
    if world_rank() is not None:
        from bigdl_tpu_torch.parallel.mesh import rank_device
        mine = torch.device("cpu") if platform == "cpu" else rank_device()
        if platform == "cuda" and mine.type != "cuda":
            raise RuntimeError("the running process world has no card "
                               "(its backend has no NCCL)")
        rows = [None] * dist.get_world_size()
        dist.all_gather_object(rows, (mine.type, mine.index, _kind(mine)))
        return ([torch.device(t, i) for t, i, _ in rows],
                [k for _, _, k in rows], True)
    if platform == "cpu":
        return [torch.device("cpu")], ["cpu"], False
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devs, [_kind(d) for d in devs], False


class DeviceTopology:
    """A frozen snapshot of a device set.

    Args:
        devices: an explicit device list; default: the live set (see the
            module docstring; unlike :meth:`detect`, this raises when the
            query fails).
        degraded: the set stands in for one the query could not read.
        per_rank: device ``i`` is world rank ``i``'s (what ``detect``
            finds with a world running); slots of such a set hold only
            their own ranks.

    Attributes:
        devices: tuple of ``torch.device``.
        platform / device_kind: of the first device (``"cuda"`` and the
            card's name, or ``"cpu"`` twice; ``"unknown"`` when empty).
    """

    def __init__(self, devices: Optional[Sequence] = None, *,
                 degraded: bool = False, per_rank: bool = False):
        kinds = None
        if devices is None:
            devices, kinds, per_rank = _probe(None)
        self.devices = tuple(torch.device(d) for d in devices)
        self.degraded = bool(degraded)
        self.per_rank = bool(per_rank)
        if self.devices:
            self.platform = self.devices[0].type
            self.device_kind = kinds[0] if kinds else _kind(self.devices[0])
        else:
            self.platform = "unknown"
            self.device_kind = "unknown"

    @classmethod
    def detect(cls, platform: Optional[str] = None) -> "DeviceTopology":
        """The live device set; never raises.  ``platform`` ``"cuda"``
        or ``None`` asks for the cards (with a world: each rank's
        device), ``"cpu"`` for the host.  A query that fails yields an
        empty degraded topology instead of wedging the caller: the
        serving stack then surfaces the real error where it builds on
        the device."""
        try:
            devs, kinds, per_rank = _probe(platform)
        except Exception:  # noqa: BLE001 - the device query is the hazard
            return cls(devices=(), degraded=True)
        topo = cls(devs, per_rank=per_rank)
        if kinds:
            topo.device_kind = kinds[0]
        return topo

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def describe(self) -> dict:
        """One serializable snapshot, with the reference's keys."""
        return {
            "platform": self.platform,
            "device_kind": self.device_kind,
            "n_devices": self.n_devices,
            "degraded": self.degraded,
            "devices": [
                {"id": i, "platform": d.type,
                 "process_index": i if self.per_rank else 0}
                for i, d in enumerate(self.devices)],
        }

    def __repr__(self) -> str:
        return (f"DeviceTopology({self.n_devices}x{self.platform}"
                f"{', degraded' if self.degraded else ''})")
