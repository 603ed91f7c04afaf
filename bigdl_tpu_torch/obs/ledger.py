"""MemoryLedger: process-wide device byte attribution (port of
``bigdl_tpu/obs/ledger.py``).

The serving stack holds device memory in several subsystems: the staged
parameters, the paged KV arenas (and int8 scale arenas), the spec
drafter's dense arena, the CUDA-graph pools of the engines, the host KV
tier's residency.  Every long-lived allocation registers ``(subsystem,
name, nbytes, shape/dtype)`` as a static byte count, a computed provider
or a live tensor held by weakref, so the ledger never pins what it
accounts.

**What "in use" and "capacity" mean on a CUDA card.**  Three byte counts
differ: the caching allocator's allocated bytes (live tensors), its
reserved bytes (the segments it holds from the device: every tensor and
every CUDA-graph pool lives in them), and the device's used bytes (the
reserved bytes plus the CUDA context, the kernels' modules, cuBLAS and
other libraries' handles outside the allocator, and other processes).

- ``bytes_in_use`` is the allocator's **reserved** bytes.  A graph pool
  is a private pool of the same allocator whose segments are held whole
  while its graphs live, so only reserved bytes contain it, once; the
  ledger attributes each pool once (its segments' total), never again
  under the arenas, which were allocated before any capture.  The drift
  is then the allocator's cached slack plus live tensors nobody
  registered.
- ``bytes_limit`` (the capacity ``used_fraction`` divides by) is the
  reserved bytes plus the device's free bytes: the most this process's
  allocator could hold now.  The context, the libraries' handles and
  other processes' memory are outside both numerator and denominator,
  so the watermark fires when the allocator nears what it can actually
  get, which is when an out-of-memory error would follow.

Budget resolution order: an explicit ``budget_bytes``, the backend's
``bytes_limit``, then ``BIGDL_TPU_MEM_BUDGET``; unknown is permissive
(``None``).  On the CPU the backend cannot be read: ``reconcile``
reports ``verdict: "degraded"`` with drift pinned at 0, the reference's
degraded path.  Crossing the ``BIGDL_TPU_MEM_WATERMARK`` used fraction
(default 0.9) fires ONE ``mem_pressure`` flight bundle carrying the
attribution table.

Executables: the port has no ahead-of-time compiled executable and no
XLA ``cost_analysis``.  Each captured CUDA graph files a row with its
engine's graph-pool bytes at capture time and ``cost=None``
(:meth:`record_compiled`); the pool's standing bytes are attributed
once, through the entry its owner registers.

Gauges land in the registry under ``obs/ledger/*`` and ``obs/xcost/*``;
the per-entry and per-executable tables ride flight bundles (state
provider ``memledger``).  :func:`get_ledger` is the process-wide
instance; :func:`set_ledger` swaps it (test injection).
"""
from __future__ import annotations

import logging
import os
import threading
import weakref
from typing import Callable, Dict, List, Optional, Tuple

from bigdl_tpu_torch.obs.registry import FnGauge, MetricRegistry, get_registry

log = logging.getLogger("bigdl_tpu_torch.obs.ledger")

__all__ = ["MemoryLedger", "get_ledger", "set_ledger", "env_watermark"]

#: used-fraction threshold past which the ledger reports pressure
DEFAULT_WATERMARK = 0.9


def env_watermark() -> float:
    try:
        v = float(os.environ.get("BIGDL_TPU_MEM_WATERMARK",
                                 DEFAULT_WATERMARK))
    except ValueError:
        return DEFAULT_WATERMARK
    return v if 0.0 < v <= 1.0 else DEFAULT_WATERMARK


def _env_budget() -> Optional[int]:
    v = os.environ.get("BIGDL_TPU_MEM_BUDGET")
    if not v:
        return None
    try:
        return int(float(v))
    except ValueError:
        return None


class _Entry:
    """One registered allocation; ``provider`` is a weakref to a live
    array, a callable returning bytes, or a static int."""

    __slots__ = ("subsystem", "name", "provider", "shape", "dtype",
                 "device", "note")

    def __init__(self, subsystem: str, name: str, provider,
                 shape, dtype, device, note):
        self.subsystem = subsystem
        self.name = name
        self.provider = provider
        self.shape = shape
        self.dtype = dtype
        self.device = device
        self.note = note


class MemoryLedger:
    """Byte-attribution plane + executable cost observatory.

    Args:
        registry: metric registry to publish ``obs/ledger/*`` /
            ``obs/xcost/*`` gauges into (default: the process-wide
            one).  All gauges register with ``replace=True`` — the
            latest ledger owns the names.
        watermark: used-fraction pressure threshold (default
            ``BIGDL_TPU_MEM_WATERMARK`` or 0.9).
        budget_bytes: explicit device byte budget, overriding the
            backend's ``bytes_limit`` and ``BIGDL_TPU_MEM_BUDGET``
            (tests inject tiny budgets this way).
    """

    def __init__(self, *, registry: Optional[MetricRegistry] = None,
                 watermark: Optional[float] = None,
                 budget_bytes: Optional[int] = None):
        self.watermark = (env_watermark() if watermark is None
                          else float(watermark))
        self.budget_bytes = (int(budget_bytes)
                             if budget_bytes is not None else None)
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], _Entry] = {}
        self._xcost: Dict[Tuple[str, str], dict] = {}
        self._last_reconcile: Optional[dict] = None
        self._registry = registry if registry is not None else get_registry()
        self._published: set = set()
        self._publish_base()
        self._register_flight_provider()

    # -- registration --------------------------------------------------- #
    def register(self, subsystem: str, name: str, provider, *,
                 shape=None, dtype=None, device: Optional[str] = None,
                 note: str = "") -> Tuple[str, str]:
        """Attribute one long-lived allocation to ``(subsystem, name)``
        (re-registering replaces — the latest owner wins, like the
        registry's ``replace=True``).  ``provider`` is a static byte
        count, a zero-arg callable returning bytes (``None`` -> stale),
        or a live array (``nbytes``/``shape``/``dtype`` captured, the
        array held by weakref so the ledger never extends its life).
        Returns the entry key for :meth:`release`."""
        if hasattr(provider, "nbytes") and not callable(provider):
            if shape is None:
                shape = tuple(getattr(provider, "shape", ()) or ())
            if dtype is None:
                dtype = str(getattr(provider, "dtype", "") or "")
            try:
                provider = weakref.ref(provider)
            except TypeError:
                # not weakref-able (slots-only wrappers): fall back to
                # a static count — safer than pinning the buffer alive
                provider = int(provider.nbytes)
        entry = _Entry(str(subsystem), str(name), provider,
                       tuple(shape) if shape is not None else None,
                       str(dtype) if dtype is not None else None,
                       device, note)
        key = (entry.subsystem, entry.name)
        with self._lock:
            self._entries[key] = entry
        self._publish_subsystem(entry.subsystem)
        return key

    def release(self, subsystem: str, name: str) -> bool:
        """Drop one attribution; True if it existed."""
        with self._lock:
            return self._entries.pop((str(subsystem), str(name)),
                                     None) is not None

    @staticmethod
    def _resolve(entry: _Entry) -> Optional[int]:
        p = entry.provider
        try:
            if isinstance(p, weakref.ref):
                obj = p()
                return None if obj is None else int(obj.nbytes)
            if callable(p):
                v = p()
                return None if v is None else int(v)
            return int(p)
        except Exception:
            return None

    # -- executable cost rows ------------------------------------------- #
    @staticmethod
    def analyze_compiled(graphs) -> Tuple[Optional[dict],
                                          Optional[dict]]:
        """``(memory, cost)`` for one captured step: ``memory`` holds the
        owner's graph-pool bytes (``GraphPool.pool_bytes``, None when the
        allocator does not name pools or nothing was captured), ``cost``
        is None (no XLA cost analysis exists for a CUDA graph)."""
        pool = None
        try:
            pool = graphs.pool_bytes()
        except Exception:
            pool = None
        memory = {"temp_bytes": 0, "argument_bytes": 0, "output_bytes": 0,
                  "alias_bytes": 0, "code_bytes": 0, "pool_bytes": pool}
        return memory, None

    def record_compiled(self, tag: str, key: str, graphs) -> dict:
        """File one freshly captured step under ``(tag, key)``."""
        memory, cost = self.analyze_compiled(graphs)
        return self.record_executable(tag, key, memory=memory, cost=cost)

    def record_executable(self, tag: str, key: str, *,
                          memory: Optional[dict] = None,
                          cost: Optional[dict] = None) -> dict:
        row = {"tag": str(tag), "key": str(key),
               "memory": memory, "cost": cost}
        with self._lock:
            self._xcost[(row["tag"], row["key"])] = row
        return row

    def release_executable(self, tag: str, key: str) -> bool:
        with self._lock:
            return self._xcost.pop((str(tag), str(key)), None) is not None

    def executables(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._xcost.values()]

    def _xcost_totals(self) -> dict:
        with self._lock:
            rows = list(self._xcost.values())
        tot = {"executables": len(rows), "flops": 0.0,
               "bytes_accessed": 0.0, "code_bytes": 0,
               "temp_bytes": 0, "output_bytes": 0}
        for r in rows:
            c, m = r.get("cost"), r.get("memory")
            if c:
                tot["flops"] += c.get("flops") or 0.0
                tot["bytes_accessed"] += c.get("bytes_accessed") or 0.0
            if m:
                tot["code_bytes"] += m.get("code_bytes") or 0
                tot["temp_bytes"] += m.get("temp_bytes") or 0
                tot["output_bytes"] += m.get("output_bytes") or 0
        return tot

    # -- attribution ----------------------------------------------------- #
    def entries(self) -> List[dict]:
        """The attribution table: one row per registration, stale
        providers (dead weakrefs, raising callables) reported at 0
        bytes with ``stale: true`` instead of silently vanishing."""
        with self._lock:
            items = list(self._entries.values())
        rows = []
        for e in items:
            n = self._resolve(e)
            row = {"subsystem": e.subsystem, "name": e.name,
                   "nbytes": int(n) if n is not None else 0,
                   "stale": n is None}
            if e.shape is not None:
                row["shape"] = list(e.shape)
            if e.dtype:
                row["dtype"] = e.dtype
            if e.device is not None:
                row["device"] = e.device
            if e.note:
                row["note"] = e.note
            rows.append(row)
        rows.sort(key=lambda r: (r["subsystem"], r["name"]))
        return rows

    def attribution(self) -> Dict[str, int]:
        """Bytes per subsystem; executables contribute their resident
        generated-code bytes as the synthetic ``executables``
        subsystem (temp/argument bytes are transient per call, not a
        standing claim)."""
        out: Dict[str, int] = {}
        for row in self.entries():
            out[row["subsystem"]] = (out.get(row["subsystem"], 0)
                                     + row["nbytes"])
        code = self._xcost_totals()["code_bytes"]
        if code:
            out["executables"] = out.get("executables", 0) + int(code)
        return out

    def total_bytes(self) -> int:
        return sum(self.attribution().values())

    # -- reconciliation / capacity --------------------------------------- #
    @staticmethod
    def backend_stats(device=None) -> Optional[dict]:
        """The CUDA allocator's and the device's byte counts for ``device``
        (the current CUDA device when none is given and this process has
        initialised CUDA); ``None`` on the CPU, the degraded path, and on
        a thread whose current stream is capturing a graph.  Keys:
        ``bytes_in_use`` (allocator reserved), ``bytes_limit`` (reserved
        plus device free), ``allocated_bytes``, ``reserved_bytes``,
        ``device_used_bytes``, ``device_total_bytes``; see the module
        docstring for why in-use and limit are these."""
        try:
            import torch
            if device is None:
                if not torch.cuda.is_initialized():
                    return None
                device = torch.device("cuda", torch.cuda.current_device())
            device = torch.device(device)
            if device.type != "cuda" or \
                    torch.cuda.is_current_stream_capturing():
                # no device query from a thread that is capturing a CUDA
                # graph (a flight dump fired inside a step's capture)
                return None
            stats = torch.cuda.memory_stats(device)
            free, total = torch.cuda.mem_get_info(device)
        except Exception:
            return None
        reserved = int(stats.get("reserved_bytes.all.current", 0))
        return {"bytes_in_use": reserved,
                "bytes_limit": reserved + int(free),
                "allocated_bytes": int(
                    stats.get("allocated_bytes.all.current", 0)),
                "reserved_bytes": reserved,
                "device_used_bytes": int(total) - int(free),
                "device_total_bytes": int(total)}

    def reconcile(self, device=None) -> dict:
        """Ledger-vs-backend verdict.  ``reconciled``: the backend
        reports ``bytes_in_use`` and ``drift_bytes`` is the
        unattributed remainder.  ``degraded``: the backend cannot be
        read (CPU) — drift is pinned at 0 by definition (no observable
        to drift from), the verdict says so."""
        ledger = self.total_bytes()
        stats = self.backend_stats(device)
        in_use = stats.get("bytes_in_use") if stats else None
        if in_use is not None:
            out = {"ledger_bytes": ledger,
                   "backend_bytes_in_use": int(in_use),
                   "drift_bytes": int(in_use) - ledger,
                   "verdict": "reconciled"}
            for k in ("allocated_bytes", "device_used_bytes",
                      "bytes_limit"):
                if k in stats:
                    out[f"backend_{k}"] = int(stats[k])
        else:
            out = {"ledger_bytes": ledger,
                   "backend_bytes_in_use": None,
                   "drift_bytes": 0,
                   "verdict": "degraded"}
        with self._lock:
            self._last_reconcile = out
        return out

    def drift_bytes(self, device=None) -> int:
        return self.reconcile(device)["drift_bytes"]

    def capacity_bytes(self, device=None, *, stats=None) -> Optional[int]:
        if self.budget_bytes is not None:
            return self.budget_bytes
        if stats is None:
            stats = self.backend_stats(device)
        if stats:
            for key in ("bytes_limit", "bytes_reservable_limit"):
                if stats.get(key):
                    return int(stats[key])
        return _env_budget()

    def used_fraction(self, device=None) -> Optional[float]:
        """Used bytes over the byte budget; ``None`` when no budget is
        known (CPU with neither ``BIGDL_TPU_MEM_BUDGET`` nor an
        injected one) — callers treat unknown as permissive."""
        stats = self.backend_stats(device)
        cap = self.capacity_bytes(device, stats=stats)
        if not cap or cap <= 0:
            return None
        used = stats.get("bytes_in_use") if stats else None
        if used is None:
            used = self.total_bytes()
        return float(used) / float(cap)

    def headroom(self, device=None) -> Optional[float]:
        """Fraction of the device byte budget still free — THE
        capacity API (the SLO scale-up gate and admission deferral
        read this, replacing per-subsystem ad-hoc checks)."""
        uf = self.used_fraction(device)
        return None if uf is None else max(0.0, 1.0 - uf)

    def over_watermark(self, device=None) -> bool:
        uf = self.used_fraction(device)
        return uf is not None and uf >= self.watermark

    # -- pressure -> flight ---------------------------------------------- #
    def check_pressure(self, device=None, *,
                       context: Optional[dict] = None) -> Optional[str]:
        """Fire ONE ``mem_pressure`` flight bundle when usage crosses
        the watermark (the recorder's ``(kind, key)`` dedup collapses
        repeated checks of the same condition); returns the bundle
        path, or ``None`` when under the watermark, disabled, or
        deduplicated.  The detail carries the full attribution table —
        the forensics RESOURCE_EXHAUSTED would otherwise destroy."""
        uf = self.used_fraction(device)
        if uf is None or uf < self.watermark:
            return None
        detail = {
            "used_fraction": round(uf, 6),
            "watermark": self.watermark,
            "headroom": round(max(0.0, 1.0 - uf), 6),
            "capacity_bytes": self.capacity_bytes(device),
            "ledger_bytes": self.total_bytes(),
            "attribution": self.attribution(),
            "table": self.entries(),
        }
        if isinstance(context, str):
            # pressure checks must never crash a serving path over a
            # sloppy caller; fold a bare-string context into the detail
            context = {"context": context}
        if context:
            detail.update(context)
        try:
            from bigdl_tpu_torch.obs import flight
            return flight.get_flight_recorder().record(
                "mem_pressure", detail, key="memledger")
        except Exception:
            log.exception("mem_pressure flight dump failed")
            return None

    # -- snapshots -------------------------------------------------------- #
    def summary(self) -> dict:
        """Backend-free totals (safe while a kernel is wedged:
        ``diagnose_cuda`` embeds this): ledger bytes, subsystem count,
        and the LAST reconcile verdict rather than a fresh backend
        read."""
        attr = self.attribution()
        with self._lock:
            last = dict(self._last_reconcile) if self._last_reconcile \
                else None
        return {"ledger_bytes": sum(attr.values()),
                "subsystems": len(attr),
                "entries": len(self._entries),
                "executables": len(self._xcost),
                "watermark": self.watermark,
                "last_reconcile": last}

    def stats(self, *, fresh: bool = True) -> dict:
        """Totals, the executable totals, the watermark, the headroom
        (None unless ``fresh``: a fresh read queries the device) and the
        last reconcile."""
        return {"attribution": self.attribution(),
                "total_bytes": self.total_bytes(),
                "xcost": self._xcost_totals(),
                "watermark": self.watermark,
                "headroom": self.headroom() if fresh else None,
                "reconcile": (self._last_reconcile
                              or {"verdict": "never_run"})}

    # -- gauge publication ------------------------------------------------ #
    def _publish_base(self) -> None:
        reg = self._registry
        try:
            reg.register("obs/ledger/total_bytes",
                         FnGauge(lambda: float(self.total_bytes())),
                         replace=True)
            reg.register("obs/ledger/drift_bytes",
                         FnGauge(lambda: float(self.drift_bytes())),
                         replace=True)
            reg.register("obs/ledger/headroom",
                         FnGauge(self.headroom), replace=True)
            reg.register("obs/ledger/watermark",
                         FnGauge(lambda: self.watermark), replace=True)
            for key in ("executables", "flops", "bytes_accessed",
                        "code_bytes", "temp_bytes"):
                reg.register(
                    f"obs/xcost/{key}",
                    FnGauge(lambda k=key: float(
                        self._xcost_totals()[k])),
                    replace=True)
        except Exception:
            log.exception("ledger gauge publication failed")

    def _publish_subsystem(self, subsystem: str) -> None:
        with self._lock:
            if subsystem in self._published:
                return
            self._published.add(subsystem)
        try:
            self._registry.register(
                f"obs/ledger/{subsystem}_bytes",
                FnGauge(lambda s=subsystem: float(
                    self.attribution().get(s, 0))),
                replace=True)
        except Exception:
            log.exception("ledger subsystem gauge failed: %s", subsystem)

    def _register_flight_provider(self) -> None:
        # every flight bundle (any kind) carries the attribution table
        # + executable rows, read from host state only (no device query:
        # a dump may run while a graph is being captured); weakref'd so
        # a replaced ledger is collectable
        try:
            from bigdl_tpu_torch.obs import flight
            ref = weakref.ref(self)

            def _state():
                led = ref()
                if led is None:
                    return None
                out = led.stats(fresh=False)
                out["table"] = led.entries()
                out["executable_rows"] = led.executables()
                return out

            flight.register_state("memledger", _state)
        except Exception:
            log.exception("ledger flight-state registration failed")


#: process-wide ledger, created lazily so env knobs are read at first
#: use, not import
_GLOBAL: Optional[MemoryLedger] = None
_GLOBAL_LOCK = threading.Lock()


def get_ledger() -> MemoryLedger:
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = MemoryLedger()
        return _GLOBAL


def set_ledger(ledger: Optional[MemoryLedger]) -> Optional[MemoryLedger]:
    """Swap the process-wide ledger (test injection); returns the old
    one.  ``None`` resets to lazy re-creation."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        old = _GLOBAL
        _GLOBAL = ledger
        return old
