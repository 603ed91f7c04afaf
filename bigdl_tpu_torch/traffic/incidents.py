"""The incident log (``TUNNEL_INCIDENTS.json``): one reader and writer
(port of ``bigdl_tpu/traffic/incidents.py``).

The flight recorder appends a row for every bundle it dumps; the chaos
scheduler (:mod:`bigdl_tpu_torch.traffic.chaos`) reads the
inter-incident gaps back as the arrival process for replayed faults.
One schema::

    {"tool": "chip_opportunist",
     "incidents": [{"ts_unix": <float>, "ts": "<iso>",
                    "stage": "<stage name>", "rc": <int>,
                    "flight": "<FLIGHT_*.json path>"?}, ...]}

Reads go through :func:`bigdl_tpu_torch.utils.artifacts.load_artifact`
(a corrupt file reads as absent, with a warning; malformed rows are
dropped one by one); appends are atomic.  ``DEFAULT_PATH`` is relative
to the working directory, where this repository keeps its own log: a
caller working from the repository root passes its own ``path``.

CLI::

    python -m bigdl_tpu_torch.traffic.incidents append <stage> <rc> [--path P]
"""
from __future__ import annotations

import logging
import time
from typing import List, Optional

from bigdl_tpu_torch.utils.artifacts import load_artifact, write_artifact

log = logging.getLogger("bigdl_tpu_torch.traffic")

DEFAULT_PATH = "TUNNEL_INCIDENTS.json"


def load_incidents(path: str = DEFAULT_PATH) -> List[dict]:
    """Valid incident rows, sorted by ``ts_unix``.  Missing file,
    corrupt file, or a document without an ``incidents`` list all
    return ``[]`` (the chaos scheduler falls back to its default gap);
    individually malformed rows are dropped with a warning."""
    doc = load_artifact(path)
    if doc is None:
        return []
    rows = doc.get("incidents") if isinstance(doc, dict) else None
    if not isinstance(rows, list):
        log.warning("incident log %s has no 'incidents' list — ignoring it",
                    path)
        return []
    out = []
    for r in rows:
        if isinstance(r, dict) and isinstance(r.get("ts_unix"), (int, float)):
            out.append(r)
        else:
            log.warning("incident log %s: skipping malformed row %r",
                        path, r)
    return sorted(out, key=lambda r: float(r["ts_unix"]))


def inter_incident_gaps(incidents: List[dict]) -> List[float]:
    """Positive seconds between consecutive incidents — the empirical
    distribution the chaos scheduler resamples."""
    ts = [float(r["ts_unix"]) for r in incidents]
    return [b - a for a, b in zip(ts, ts[1:]) if b > a]


def append_incident(stage: str, rc: int, path: str = DEFAULT_PATH, *,
                    tool: str = "chip_opportunist",
                    now: Optional[float] = None,
                    flight: Optional[str] = None) -> dict:
    """Append one incident row atomically; an unreadable existing file
    starts a fresh log (load_artifact already warned).  ``flight``
    attaches the row's flight-recorder bundle pointer when one was
    dumped for this incident."""
    doc = load_artifact(path)
    if not (isinstance(doc, dict) and isinstance(doc.get("incidents"), list)):
        doc = {"tool": tool, "incidents": []}
    t = time.time() if now is None else float(now)
    row = {
        "ts_unix": round(t, 1),
        "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(t)),
        "stage": str(stage),
        "rc": int(rc),
    }
    if flight:
        row["flight"] = str(flight)
    doc["incidents"].append(row)
    write_artifact(path, doc)
    return doc


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m bigdl_tpu_torch.traffic.incidents")
    sub = ap.add_subparsers(dest="cmd", required=True)
    app = sub.add_parser("append", help="append one incident row")
    app.add_argument("stage")
    app.add_argument("rc", type=int)
    app.add_argument("--path", default=DEFAULT_PATH)
    app.add_argument("--flight", default=None,
                     help="FLIGHT_*.json bundle basename for this row")
    args = ap.parse_args(argv)
    append_incident(args.stage, args.rc, args.path, flight=args.flight)
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
