"""Deterministic fault injection at named hook points (port of
``bigdl_tpu/resilience/faults.py``).

Hook points (``fault_point(site, **ctx)``) sit in the hot paths and cost
one global read when no injector is active, and nothing can activate
one unless the ``BIGDL_TPU_FAULTS`` env var is set.

Spec grammar (``;``-separated specs)::

    BIGDL_TPU_FAULTS="site:kind[:key=val[,key=val...]][;spec...]"

    site   hook-point name; the port's engine crosses
           serving.enqueue (a transient becomes the typed
           ServingOverloaded shed), serving.verify (a transient demotes
           the round's speculating slots to plain decode; streams stay
           exact), serving.cancel (crossed once per seated stream per
           scheduler round; any fault there is that client
           disconnecting: a cooperative ``stream.cancel()``) and
           transfer.chunk (each host-to-device slice of
           ``utils.transfer.chunked_device_put``)
    kind   transient     raise TransientBackendError
           backend_lost  raise BackendLostError
           die           alias of backend_lost
           latency       sleep ms= milliseconds, then continue
    keys   p=0.25        firing probability (default 1.0; draws come
                         from one seeded stream, BIGDL_TPU_FAULTS_SEED)
           after=3       arm from the 3rd matching check on (1-based)
           count=2       fire at most twice, then go quiet
           name=r1       only match checks carrying ctx name == "r1"
           ms=50         latency kind: sleep duration

Every fire adds one to the ``resilience/faults_injected`` registry
counter, logs the spec and raises a ``fault_injected`` flight incident
(one bundle per site inside the recorder's dedup window, when the
recorder is armed).
"""
from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Optional

from bigdl_tpu_torch.resilience.errors import (BackendLostError,
                                               TransientBackendError)

log = logging.getLogger("bigdl_tpu_torch.resilience")

ENV_SPEC = "BIGDL_TPU_FAULTS"
ENV_SEED = "BIGDL_TPU_FAULTS_SEED"

_KINDS = ("transient", "backend_lost", "die", "latency")


class _FaultSpec:
    __slots__ = ("site", "kind", "p", "after", "count", "name", "ms",
                 "seen", "fired")

    def __init__(self, site: str, kind: str, *, p: float = 1.0,
                 after: int = 1, count: Optional[int] = None,
                 name: Optional[str] = None, ms: float = 0.0):
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(expected one of {_KINDS})")
        self.site = site
        self.kind = "backend_lost" if kind == "die" else kind
        self.p = float(p)
        self.after = int(after)
        self.count = None if count is None else int(count)
        self.name = name
        self.ms = float(ms)
        self.seen = 0    # matching checks observed
        self.fired = 0   # faults actually injected

    def describe(self) -> str:
        extra = []
        if self.p < 1.0:
            extra.append(f"p={self.p}")
        if self.after > 1:
            extra.append(f"after={self.after}")
        if self.count is not None:
            extra.append(f"count={self.count}")
        if self.name is not None:
            extra.append(f"name={self.name}")
        if self.kind == "latency":
            extra.append(f"ms={self.ms}")
        tail = (":" + ",".join(extra)) if extra else ""
        return f"{self.site}:{self.kind}{tail}"


def parse_spec(text: str) -> list:
    """Parse the env grammar into specs; a malformed spec raises (a
    mistyped chaos configuration silently injecting nothing would void
    the whole fault run)."""
    specs = []
    for raw in text.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        fields = raw.split(":")
        if len(fields) < 2:
            raise ValueError(
                f"bad fault spec {raw!r}: expected site:kind[:k=v,...]")
        site, kind = fields[0].strip(), fields[1].strip()
        kwargs = {}
        if len(fields) > 2:
            for pair in ":".join(fields[2:]).split(","):
                pair = pair.strip()
                if not pair:
                    continue
                if "=" not in pair:
                    raise ValueError(
                        f"bad fault spec {raw!r}: option {pair!r} "
                        "is not key=value")
                k, v = pair.split("=", 1)
                k = k.strip()
                if k in ("p", "ms"):
                    kwargs[k] = float(v)
                elif k in ("after", "count"):
                    kwargs[k] = int(v)
                elif k == "name":
                    kwargs[k] = v.strip()
                else:
                    raise ValueError(
                        f"bad fault spec {raw!r}: unknown option {k!r}")
        specs.append(_FaultSpec(site, kind, **kwargs))
    if not specs:
        raise ValueError(f"fault spec {text!r} contains no specs")
    return specs


class FaultInjector:
    """Seeded probability stream plus per-spec check counters: the same
    spec, seed and call sequence inject the same faults every run."""

    def __init__(self, specs, seed: int = 0):
        if isinstance(specs, str):
            specs = parse_spec(specs)
        self.specs = list(specs)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()

    def check(self, site: str, **ctx) -> None:
        """Raise or sleep according to the first matching armed spec."""
        for spec in self.specs:
            if spec.site != site:
                continue
            with self._lock:
                if spec.name is not None and ctx.get("name") != spec.name:
                    continue
                spec.seen += 1
                if spec.seen < spec.after:
                    continue
                if spec.count is not None and spec.fired >= spec.count:
                    continue
                # p=1.0 specs never touch the rng, so deterministic specs
                # stay independent of probabilistic ones sharing it
                if spec.p < 1.0 and self._rng.random() >= spec.p:
                    continue
                spec.fired += 1
                fired = spec.fired
            self._record(site, spec)
            detail = (f"injected fault [{spec.describe()}] at {site} "
                      f"(check {spec.seen}, firing {fired}, ctx {ctx})")
            if spec.kind == "latency":
                time.sleep(spec.ms / 1000.0)
                return
            if spec.kind == "backend_lost":
                raise BackendLostError(detail)
            raise TransientBackendError(f"UNAVAILABLE: {detail}")

    @staticmethod
    def _record(site: str, spec: _FaultSpec) -> None:
        from bigdl_tpu_torch.obs import get_registry
        get_registry().counter("resilience/faults_injected").add(1)
        log.info("fault injected: %s at %s", spec.describe(), site)
        # every fire is an incident candidate; the recorder's per-site
        # dedup window collapses a chaos sweep to one bundle per site
        try:
            from bigdl_tpu_torch.obs import flight
            flight.get_flight_recorder().record(
                "fault_injected",
                {"site": site, "spec": spec.describe()}, key=site)
        except Exception:
            log.exception("fault flight-recorder dump failed")

    def stats(self) -> dict:
        """Seen and fired counts, summed over specs that describe alike."""
        with self._lock:
            out: dict = {}
            for s in self.specs:
                d = out.setdefault(s.describe(), {"seen": 0, "fired": 0})
                d["seen"] += s.seen
                d["fired"] += s.fired
            return out


_active: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    return _active


def install(injector: Optional[FaultInjector]) -> None:
    """Activate an injector, refused unless ``BIGDL_TPU_FAULTS`` is set
    (fault injection must be an explicit, visible choice);
    ``install(None)`` always deactivates."""
    global _active
    if injector is not None and not os.environ.get(ENV_SPEC):
        raise RuntimeError(
            f"refusing to activate FaultInjector: {ENV_SPEC} is not set "
            "(fault injection must be an explicit, visible choice)")
    _active = injector


def refresh_from_env() -> Optional[FaultInjector]:
    """(Re)build the active injector from ``BIGDL_TPU_FAULTS`` and
    ``BIGDL_TPU_FAULTS_SEED``; an unset spec deactivates.  Called once at
    import, and again by callers that change the environment."""
    global _active
    spec = os.environ.get(ENV_SPEC)
    if not spec:
        _active = None
        return None
    injector = FaultInjector(spec, seed=int(os.environ.get(ENV_SEED, "0")))
    log.warning("fault injection ACTIVE (%s=%r, seed=%d)",
                ENV_SPEC, spec, injector.seed)
    _active = injector
    return injector


def fault_point(site: str, **ctx) -> None:
    """Hook point: a no-op (one global read) unless an injector is
    active.  Safe from any thread."""
    inj = _active
    if inj is not None:
        inj.check(site, **ctx)


refresh_from_env()
