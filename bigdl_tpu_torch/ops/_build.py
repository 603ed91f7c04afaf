"""Build the port's CUDA sources with ``nvcc`` and bind them with ctypes.

Each ``bigdl_tpu_torch/csrc/<name>.cu`` compiles on first use into a
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <build dir>/<name>-<hash>.so

The library's file name carries a hash of the source, of the shared
headers beside it (``csrc/*.cuh``) and of the flags, so an edited source
or header rebuilds and an unchanged one is reused.  The build
directory (``bigdl_tpu_torch/_build``) is listed in ``.gitignore``.
Libraries load with ``ctypes``: every pointer and the stream go as
``c_void_p``, every C entry point returns ``cudaGetLastError()``, and
:meth:`Kernel.launch` raises when that is not 0.  Nothing here runs at
import time: a machine without ``nvcc`` imports the port and runs the
plain PyTorch versions on CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_build_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the port's CUDA kernels build on "
                       "a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of the source, every shared
    header of ``csrc/`` (``*.cuh``, which any source may include) and
    the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes at once; returns ``{name: {"path", "seconds", "ptxas"}}``
    (``seconds`` 0.0 and no ``ptxas`` lines for a library found built).
    Raises ``RuntimeError`` with the compiler's output on failure."""
    out: Dict[str, dict] = {}
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        running = {}
        for name in names:
            lib = library_path(name)
            if lib.exists():
                out[name] = {"path": lib, "seconds": 0.0, "ptxas": []}
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            # compiler output goes to a file: a pipe nobody reads while
            # the others compile could fill and stall nvcc
            log_path = tmp.with_suffix(".log")
            with open(log_path, "w") as log_f:
                proc = subprocess.Popen(cmd, stdout=log_f,
                                        stderr=subprocess.STDOUT)
            running[name] = (proc, lib, tmp, log_path, time.perf_counter())
        ended = {}
        while len(ended) < len(running):  # each compile's own wall time
            for name, (proc, _, _, _, t0) in running.items():
                if name not in ended and proc.poll() is not None:
                    ended[name] = time.perf_counter() - t0
            time.sleep(0.02)
        for name, (proc, lib, tmp, log_path, _) in running.items():
            log = log_path.read_text()
            log_path.unlink()
            seconds = ended[name]
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on csrc/{name}.cu "
                    f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, lib)  # atomic: a reader never sees half a file
            out[name] = {"path": lib, "seconds": seconds,
                         "ptxas": [ln.strip() for ln in log.splitlines()
                                   if "ptxas" in ln or "spill" in ln]}
    return out


_counting = threading.local()   # per thread: .capture and .tally dicts
_count_lock = threading.Lock()


class recording_launches:
    """Context manager: the launches this thread makes inside it go into
    the yielded dict (kernel -> count) instead of the counters.  The
    graph cache wraps each capture in it (a capture runs nothing; the
    graph adds its recorded counts on every replay), so a capture on one
    thread never takes back launches another thread made meanwhile."""

    def __enter__(self) -> dict:
        self._prev = getattr(_counting, "capture", None)
        _counting.capture = {}
        return _counting.capture

    def __exit__(self, *exc) -> None:
        _counting.capture = self._prev


def tally_launches(tally) -> None:
    """Count every launch this thread makes from now on into ``tally``
    (symbol -> count) too, beside the kernel's own counter: a serving
    worker's launches are its engine's (``None`` stops the tally)."""
    _counting.tally = tally


class Kernel:
    """One hand-written CUDA kernel behind a C entry point.

    ``launches`` counts successful launches; the wrapper that owns the
    kernel is the only caller of :meth:`launch`.  A launch made while a
    CUDA graph is captured runs nothing then: the graph cache
    (``serving/compile_cache.py``) records such counts in
    :class:`recording_launches` instead and adds them (:meth:`count`)
    on every replay, so ``launches`` counts what the device ran.  The
    counters are safe to bump from several threads (one serving worker
    an engine).  The library must be built and loaded before a capture:
    a first launch inside one raises.
    """

    def __init__(self, source: str, symbol: str,
                 argtypes: Sequence[type]):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._lib = None
        self._fn = None
        self._err = None

    def _entry(self):
        if self._fn is None:
            import torch
            if (torch.cuda.is_available()
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(
                    f"{self.symbol}: first launch inside a CUDA graph "
                    "capture; run the step once eagerly first, so the "
                    "library builds and loads outside the capture")
            path = build([self.source])[self.source]["path"]
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.bigdl_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self._err, self._fn = lib, err, fn
        return self._fn

    def launch(self, *args) -> None:
        code = self._entry()(*args)
        if code != 0:
            raise RuntimeError(
                f"{self.symbol} failed to launch: CUDA error {code} "
                f"({self._err(code).decode()})")
        self.count(1)

    def count(self, n: int) -> None:
        """Book ``n`` launches: into this thread's capture record while
        one is open, else into ``launches`` and this thread's tally."""
        rec = getattr(_counting, "capture", None)
        if rec is not None:
            rec[self] = rec.get(self, 0) + n
            return
        with _count_lock:
            self.launches += n
        tally = getattr(_counting, "tally", None)
        if tally is not None:
            tally[self.symbol] = tally.get(self.symbol, 0) + n
