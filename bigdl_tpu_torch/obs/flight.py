"""Incident flight recorder: one correlated bundle per incident (port
of ``bigdl_tpu/obs/flight.py``).

When something goes wrong in the serving or training stack (a watchdog
stall, a fault-injector fire, a corrupt host-tier spill, a shed burst,
the memory ledger crossing its watermark as ``mem_pressure``) the
recorder freezes the evidence into one atomically written
``FLIGHT_<ts>.json`` bundle:

- the last N trace spans and the active request ids;
- the time-series window of the process sampler, when one is
  installed;
- :func:`bigdl_tpu_torch.device.diagnose_cuda` under ``diagnose_cuda``
  (where the reference writes ``diagnose_tpu``): a ``/proc`` scan and
  the memory ledger's last reconcile, safe while a kernel is wedged;
- registered state providers (engine stats, replica-set stats, the
  ledger's table); a provider that raises contributes its error string;
- a pointer row appended to the incident log (``TUNNEL_INCIDENTS.json``
  through :mod:`bigdl_tpu_torch.traffic.incidents`).

**No part of a dump synchronises the device.**  The watchdog dumps from
its own thread while a step may be stuck, and a fault may fire on a
thread that is capturing a CUDA graph: providers read host state only
(no ``.item()``, ``.cpu()``, ``.tolist()`` of a device tensor, no
``torch.cuda.synchronize``, no query of the device's free memory).

Recording is OFF by default (``BIGDL_TPU_FLIGHT=1`` or
``configure(enabled=True)`` arms it).  Bundles land under ``flight/`` of
the working directory (``BIGDL_TPU_FLIGHT_DIR`` moves them) and rotate
at dump time past ``BIGDL_TPU_FLIGHT_MAX`` (default 64); the incident
log defaults to ``TUNNEL_INCIDENTS.json`` of the working directory.
Both defaults are files of this repository's root: a caller that arms
the recorder from there passes ``out_dir`` and ``incidents_path``.
Bundles dedup on ``(kind, key)`` within ``dedup_window_s``.

CLI::

    python -m bigdl_tpu_torch.obs.flight dump <stage> <rc> [--dir DIR]
"""
from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from bigdl_tpu_torch.obs.registry import get_registry
from bigdl_tpu_torch.obs.timeseries import get_sampler
from bigdl_tpu_torch.obs.tracer import get_tracer

log = logging.getLogger("bigdl_tpu_torch.obs.flight")

__all__ = ["FlightRecorder", "get_flight_recorder", "configure",
           "register_state", "register_requests", "note_shed"]


def _env_enabled() -> bool:
    return os.environ.get("BIGDL_TPU_FLIGHT", "0").lower() \
        in ("1", "true", "on")


class FlightRecorder:
    """Correlated incident-bundle dumper with per-incident dedup."""

    #: incident kinds the serving stack wires up (detail carries the
    #: specifics); ad-hoc kinds are allowed — the schema only pins shape
    KINDS = ("stall", "backend_lost", "fault_injected", "shed_burst",
             "probe_death", "stage_death", "mem_pressure")

    def __init__(self, *, enabled: Optional[bool] = None,
                 out_dir: Optional[str] = None,
                 incidents_path: Optional[str] = None,
                 max_spans: int = 512,
                 dedup_window_s: float = 30.0,
                 shed_burst_threshold: int = 32,
                 shed_burst_window_s: float = 5.0,
                 max_bundles: Optional[int] = None):
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        # incident-ledger pointers carry the subdir
        self.out_dir = (out_dir
                        or os.environ.get("BIGDL_TPU_FLIGHT_DIR")
                        or os.path.join(os.getcwd(), "flight"))
        if max_bundles is None:
            try:
                max_bundles = int(os.environ.get(
                    "BIGDL_TPU_FLIGHT_MAX", "64"))
            except ValueError:
                max_bundles = 64
        #: rotation bound: at dump time the oldest FLIGHT_*.json past
        #: this count are pruned from out_dir (<= 0 disables)
        self.max_bundles = int(max_bundles)
        #: None -> traffic.incidents.DEFAULT_PATH, resolved at dump time
        self.incidents_path = incidents_path
        self.max_spans = int(max_spans)
        self.dedup_window_s = float(dedup_window_s)
        self.shed_burst_threshold = int(shed_burst_threshold)
        self.shed_burst_window_s = float(shed_burst_window_s)
        self._lock = threading.Lock()
        self._last_by_key: Dict[tuple, float] = {}
        self._state_providers: Dict[str, Callable[[], object]] = {}
        self._request_providers: Dict[str, Callable[[], list]] = {}
        self._shed_times: deque = deque(maxlen=4096)
        self._seq = 0
        self.bundles_written = 0
        self.last_bundle_path: Optional[str] = None

    # -- provider registration ------------------------------------------ #
    def register_state(self, key: str,
                       fn: Callable[[], object]) -> None:
        """Bind a state snapshot callable (BlockPool stats, placement,
        spec, circuit states...) under ``key``; latest owner wins, the
        FnGauge idiom."""
        with self._lock:
            self._state_providers[key] = fn

    def register_requests(self, key: str,
                          fn: Callable[[], list]) -> None:
        """Bind an active-request-id provider (engine slots + queue)."""
        with self._lock:
            self._request_providers[key] = fn

    def unregister(self, key: str) -> None:
        with self._lock:
            self._state_providers.pop(key, None)
            self._request_providers.pop(key, None)

    # -- triggers ------------------------------------------------------- #
    def note_shed(self) -> Optional[str]:
        """Called per shed (queue-full rejection); records ONE bundle
        when sheds exceed the burst threshold within the window, then
        the dedup window re-arms it."""
        if not self.enabled:
            return None
        now = time.time()
        with self._lock:
            self._shed_times.append(now)
            cutoff = now - self.shed_burst_window_s
            recent = sum(1 for t in self._shed_times if t >= cutoff)
        if recent < self.shed_burst_threshold:
            return None
        return self.record("shed_burst",
                           {"sheds_in_window": recent,
                            "window_s": self.shed_burst_window_s},
                           key="shed")

    def record(self, kind: str, detail: Optional[dict] = None, *,
               key: Optional[str] = None) -> Optional[str]:
        """Dump one bundle for this incident; returns its path, or
        ``None`` when disabled or deduplicated.  ``key`` scopes the
        dedup — two different fault sites are distinct incidents, two
        fires of the same site inside ``dedup_window_s`` are one."""
        if not self.enabled:
            return None
        now = time.time()
        dkey = (kind, key)
        with self._lock:
            last = self._last_by_key.get(dkey)
            if last is not None and now - last < self.dedup_window_s:
                return None
            self._last_by_key[dkey] = now
            self._seq += 1
            seq = self._seq
        try:
            return self._dump(kind, detail or {}, now, seq)
        except Exception:
            log.exception("flight recorder failed dumping %r", kind)
            return None

    # -- bundle assembly ------------------------------------------------ #
    def _dump(self, kind: str, detail: dict, now: float, seq: int) -> str:
        tracer = get_tracer()
        spans = tracer.events()[-self.max_spans:]
        sampler = get_sampler()
        window = sampler.window() if sampler is not None else []
        with self._lock:
            state_providers = dict(self._state_providers)
            request_providers = dict(self._request_providers)
        state = {}
        for pkey, fn in state_providers.items():
            try:
                state[pkey] = fn()
            except Exception as e:
                state[pkey] = f"capture failed: {e}"
        active: dict = {}
        for pkey, fn in request_providers.items():
            try:
                active[pkey] = list(fn())
            except Exception as e:
                active[pkey] = [f"capture failed: {e}"]
        try:
            from bigdl_tpu_torch.device import diagnose_cuda
            diagnose = diagnose_cuda()
        except Exception as e:  # pragma: no cover - diagnose is /proc-only
            diagnose = f"capture failed: {e}"
        try:
            from bigdl_tpu_torch.utils.artifacts import platform_stamp
            platform = platform_stamp()
        except Exception as e:  # pragma: no cover
            platform = f"capture failed: {e}"
        bundle = {
            "flight": kind,
            "ts_unix": round(now, 3),
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(now)),
            "detail": detail,
            "spans": spans,
            "active_requests": active,
            "timeseries": window,
            "state": state,
            "registry": get_registry().snapshot(),
            "diagnose_cuda": diagnose,
            "platform": platform,
            "complete": True,
        }
        stamp = time.strftime("%Y%m%d_%H%M%S", time.localtime(now))
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir,
                            f"FLIGHT_{stamp}_{os.getpid()}_{seq}.json")
        from bigdl_tpu_torch.utils.artifacts import write_artifact
        write_artifact(path, bundle)
        with self._lock:
            self.bundles_written += 1
            self.last_bundle_path = path
        self._rotate()
        self._append_incident_pointer(kind, detail, path)
        log.warning("flight recorder: %s -> %s", kind, path)
        return path

    def _rotate(self) -> None:
        """Prune the oldest bundles past ``max_bundles``
        (``BIGDL_TPU_FLIGHT_MAX``) — the stamp-named files sort
        chronologically, so name order IS age order."""
        if self.max_bundles <= 0:
            return
        try:
            names = sorted(n for n in os.listdir(self.out_dir)
                           if n.startswith("FLIGHT_")
                           and n.endswith(".json"))
            for name in names[:-self.max_bundles]:
                os.remove(os.path.join(self.out_dir, name))
        except OSError:
            log.exception("flight bundle rotation failed in %s",
                          self.out_dir)

    def _append_incident_pointer(self, kind: str, detail: dict,
                                 path: str) -> None:
        try:
            from bigdl_tpu_torch.traffic import incidents
            # a CLI dump carries its stage/rc verbatim; in-process
            # triggers self-name
            stage = f"flight/{kind}"
            rc = 0
            if isinstance(detail, dict):
                stage = str(detail.get("stage", stage))
                try:
                    rc = int(detail.get("rc", 0))
                except (TypeError, ValueError):
                    rc = 0
            try:
                # pointer keeps the flight/ prefix so the ledger row
                # resolves from the repo root
                pointer = os.path.relpath(path, os.getcwd())
                if pointer.startswith(".."):
                    pointer = path
            except ValueError:
                pointer = os.path.basename(path)
            incidents.append_incident(
                stage=stage, rc=rc,
                path=self.incidents_path or incidents.DEFAULT_PATH,
                flight=pointer)
        except Exception:
            log.exception("flight recorder: incident pointer append "
                          "failed for %s", path)


#: process-wide recorder: triggers all over the stack (watchdog, fault
#: injector, host tier, memory ledger, engine sheds) report into it
_GLOBAL = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _GLOBAL


def configure(**kw) -> FlightRecorder:
    """Rebind the process-wide recorder (``configure(enabled=True,
    out_dir=...)``); providers registered on the old one carry over."""
    global _GLOBAL
    old = _GLOBAL
    rec = FlightRecorder(**kw)
    with old._lock:
        rec._state_providers.update(old._state_providers)
        rec._request_providers.update(old._request_providers)
    _GLOBAL = rec
    return rec


# module-level conveniences for the hot-path call sites
def register_state(key: str, fn: Callable[[], object]) -> None:
    _GLOBAL.register_state(key, fn)


def register_requests(key: str, fn: Callable[[], list]) -> None:
    _GLOBAL.register_requests(key, fn)


def note_shed() -> Optional[str]:
    return _GLOBAL.note_shed()


def _main(argv) -> int:
    """``python -m bigdl_tpu_torch.obs.flight dump <stage> <rc> [--dir D]``"""
    if len(argv) < 3 or argv[0] != "dump":
        print(__doc__.strip().splitlines()[0], file=sys.stderr)
        print("usage: python -m bigdl_tpu_torch.obs.flight dump <stage> <rc> "
              "[--dir DIR]", file=sys.stderr)
        return 2
    stage, rc = argv[1], int(argv[2])
    out_dir = None
    if "--dir" in argv:
        out_dir = argv[argv.index("--dir") + 1]
    kind = "probe_death" if stage == "probe" else "stage_death"
    rec = FlightRecorder(enabled=True, out_dir=out_dir,
                         dedup_window_s=0.0)
    path = rec.record(kind, {"stage": stage, "rc": rc})
    if path is None:
        return 1
    print(json.dumps({"flight": kind, "stage": stage, "rc": rc,
                      "path": path}))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised by the shell
    sys.exit(_main(sys.argv[1:]))
