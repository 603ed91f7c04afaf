"""Named metric counters (port of ``bigdl_tpu/optim/metrics.py``; ref
optim/Metrics.scala:24-112).

A metric is local to the process.  Storage is
:class:`bigdl_tpu_torch.obs.registry.Counter` objects, so the training
loop's phase counters publish into the process-wide registry
(``publish_to``) and ride the same snapshot and tfevents export path as
the serving metrics.  ``aggregate()``, the reference's cross-process
mean, is a no-op in one process; under an initialised
``torch.distributed`` it raises: the port's distributed training is
ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

import threading

from bigdl_tpu_torch.obs.registry import Counter, MetricRegistry


class Metrics:
    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._lock = threading.Lock()
        self._published: list[tuple[MetricRegistry, str]] = []

    # -- registry wiring ------------------------------------------------ #
    def publish_to(self, registry: MetricRegistry,
                   prefix: str = "train/") -> "Metrics":
        """Expose every counter (current and future) in ``registry``
        under ``prefix`` — live objects, not copies; latest publisher
        wins the names (replace semantics)."""
        with self._lock:
            self._published.append((registry, prefix))
            for name, c in self._counters.items():
                registry.register(prefix + name, c, replace=True)
        return self

    def _counter(self, name: str, unit: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = Counter(unit=unit)
            self._counters[name] = c
            for registry, prefix in self._published:
                registry.register(prefix + name, c, replace=True)
        return c

    # -- recording ------------------------------------------------------ #
    def set(self, name: str, value: float, parallel: int = 1,
            unit: str = "s") -> None:
        with self._lock:
            self._counter(name, unit).set(float(value), parallel)

    def add(self, name: str, value: float, unit: str = "s") -> None:
        with self._lock:
            self._counter(name, unit).add(float(value))

    def get(self, name: str) -> tuple[float, int]:
        with self._lock:
            c = self._counters.get(name)
            return c.get() if c is not None else (0.0, 1)

    # -- aggregation / reporting ---------------------------------------- #
    def aggregate(self) -> "Metrics":
        """Cross-process mean of every counter: ``self`` with one
        process.  The port trains in one process; under an initialised
        ``torch.distributed`` this raises instead of returning a local
        view as the fleet's."""
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise NotImplementedError(
                "Metrics.aggregate across processes is not ported "
                "(ROADMAP Queue 1 item 12, distributed training)")
        return self

    def summary(self, unit_scale: float = 1.0) -> str:
        """Per-phase means.  Time counters (``unit="s"``, the default —
        values recorded in seconds; the reference stores nanoseconds and
        divides by 1e9, optim/Metrics.scala:96) are scaled by
        ``unit_scale`` and labeled `` s``; counters recorded with any
        other unit print their raw value — a batch count must not be
        stamped as seconds — with their own unit suffix when one was
        given."""
        with self._lock:
            lines = ["========== Metrics Summary =========="]
            for name, c in self._counters.items():
                v, n = c.get()
                mean = v / max(n, 1)
                if c.unit == "s":
                    lines.append(f"{name} : {mean / unit_scale} s")
                elif c.unit:
                    lines.append(f"{name} : {mean} {c.unit}")
                else:
                    lines.append(f"{name} : {mean}")
            lines.append("=====================================")
            return "\n".join(lines)
