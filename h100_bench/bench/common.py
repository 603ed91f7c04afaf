"""The benchmark's catalog and plumbing, driven by data.

A workload (cell) of ``BENCHMARK.json`` names a configuration and a
traffic mix.  The harness finds everything else by name:

- ``h100_bench/cells/<workload>.json``: the runner and the system's
  settings for the cell; the runner is ``h100_bench/runners/<runner>.py``;
- ``h100_bench/traffic/<traffic>.json``: the mix's parameters, read by
  the generator its ``kind`` names, ``h100_bench/traffic/kinds/<kind>.py``
  (a serving kind takes its arrival process by name too, from
  ``h100_bench/traffic/arrivals/<process>.py``);
- the configuration's ``file`` (``h100_bench/configs/<name>.json``);
- ``h100_bench/metrics/<metric>.py``: one reader per per-layer metric.

A later change adds a cell, a mix, a configuration, a runner, a traffic
kind, an arrival process or a metric by adding such files and an entry
in ``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

#: the checkout's root (``h100_bench/bench/common.py`` is two levels down)
ROOT = Path(__file__).resolve().parents[2]

#: top-level module names that must never be loaded in a measured run:
#: the JAX stack and the JAX package the port was made from
FORBIDDEN_TOP_LEVEL = ("jax", "jaxlib", "flax", "bigdl_tpu")

#: a name of the catalog: a metric, a cell, a runner, a kind
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a cell the catalog does
    not describe, a forbidden import); the run exits non-zero."""


# -- the catalog -------------------------------------------------------- #
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


class Cell:
    """Everything one workload of ``BENCHMARK.json`` names, read from
    its files."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        root = Path(root)
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise BenchError(f"no workload {name!r} in BENCHMARK.json "
                             f"(have {sorted(by_name)})")
        self.root = root
        self.bench = bench
        self.name = name
        self.workload = by_name[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.settings = load_json(root / "h100_bench" / "cells"
                                  / f"{name}.json")
        self.traffic = load_json(root / "h100_bench" / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.chips = int(self.workload["chips"])

    @property
    def runner(self) -> str:
        return self.settings["runner"]

    def runner_module(self):
        """``h100_bench/runners/<runner>.py``: its ``Run`` class and
        ``run_cell``."""
        return plugin("runners", self.runner, self.root)

    def traffic_kind(self):
        """The generator of this cell's mix,
        ``h100_bench/traffic/kinds/<kind>.py``."""
        return plugin("traffic/kinds", self.traffic["kind"], self.root)

    def metrics(self, trace: bool) -> List[dict]:
        """The metric entries this cell reports in a run with ``--trace
        trace``: the end-to-end ones, or the per-layer ones, each
        without a ``workloads`` key or with this cell in it."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[key]
                if "workloads" not in m or self.name in m["workloads"]]


_PLUGINS: Dict[Path, object] = {}


def plugin(group: str, name: str, root: Path = ROOT):
    """The module ``h100_bench/<group>/<name>.py`` under ``root`` (a name
    may hold dots), loaded from its path once a process."""
    path = (Path(root) / "h100_bench" / group / f"{name}.py").resolve()
    if path in _PLUGINS:
        return _PLUGINS[path]
    if not NAME.match(name) or not path.exists():
        raise BenchError(f"no {group} module {name!r} ({path})")
    tag = "".join(c if c.isalnum() else "_" for c in f"{group}_{name}")
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_plugin_{tag}_{len(_PLUGINS)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _PLUGINS[path] = mod
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The reader module of per-layer metric ``name``
    (``h100_bench/metrics/<name>.py``): its ``read(ctx)`` returns the
    value or None."""
    return plugin("metrics", name, root)


# -- the import check --------------------------------------------------- #
def forbidden_modules(names: Iterable[str]) -> List[str]:
    """Loaded module names whose top-level name (the part before the
    first dot, compared whole) is forbidden: ``bigdl_tpu`` is, and
    ``bigdl_tpu_torch`` is not."""
    return sorted(n for n in names
                  if n.split(".", 1)[0] in FORBIDDEN_TOP_LEVEL)


def check_imports() -> None:
    found = forbidden_modules(list(sys.modules))
    if found:
        print("forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        raise BenchError("forbidden modules loaded: " + ", ".join(found))


# -- statistics --------------------------------------------------------- #
def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) by linear interpolation between
    the closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values: Sequence[float]) -> float:
    return percentile(values, 50.0)


# -- the device --------------------------------------------------------- #
def nvidia_smi() -> str:
    """``name, power.limit`` of every card, one line each, or why not."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return " | ".join(ln.strip() for ln in out.stdout.splitlines()
                      if ln.strip()) or out.stderr.strip()


def require_cuda(chips: int):
    """The card's name after checking that ``chips`` CUDA devices are
    there; raises :class:`BenchError` otherwise."""
    import torch
    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: the benchmark runs on the card")
    n = torch.cuda.device_count()
    if n < chips:
        raise BenchError(f"the cell needs {chips} CUDA devices, "
                         f"{n} present")
    return torch.cuda.get_device_name(0)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def scratch_dir(sub: str) -> Path:
    """A directory for this run's passing files (profiler traces) under
    ``TMPDIR`` (the system's temporary directory without one)."""
    import tempfile
    base = Path(tempfile.gettempdir()) / "h100_bench" / f"{sub}-{os.getpid()}"
    base.mkdir(parents=True, exist_ok=True)
    return base


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict], checks: Dict[str, dict]) -> str:
    """The run's last line of standard output; ``checks`` (each number
    compared with its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
