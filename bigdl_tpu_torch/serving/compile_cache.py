"""Shape-keyed cache of captured CUDA graphs for the serving steps (port
of ``bigdl_tpu/serving/compile_cache.py``).

The reference keeps one ahead-of-time compiled XLA executable per input
shape, with hit/miss/evict counters, an LRU bound and a warmup API, so a
serving path that pads every batch to a bucket runs all hits in steady
state.  The CUDA counterpart of an executable is one
``torch.cuda.CUDAGraph`` per shape, captured once and replayed.  Entries
are keyed on

    (per-leaf (shape, dtype) of the inputs, params dtype tag,
     params compute tag)

where the dtype tag is the reference's ``quant.params_dtype_tag``
("int8" when a params leaf is a QTensor, else "bf16" when one is
bfloat16, else "f32") and the compute tag the dominant compute mode of
the QTensor leaves (``quant.params_compute_tag``; None for a float
tree), which the reference's pytree aux keeps apart: an int8 tree and a
float tree, or one int8 payload under two compute modes, never share a
graph.  The port has no placement, so it has no placement tag.

On a CUDA device an entry is a captured graph (:class:`GraphPool`
makes it): static device tensors for the inputs, pinned host buffers to
stage them, and references to the graph's outputs.  Making one copies
the example inputs into the static tensors, runs the function once
eagerly on the pool's side stream (cuBLAS handles and workspaces, the
kernels' ctypes libraries and their shared-memory attributes load there,
since no build or load may happen inside a capture), then captures it on
the same stream under ``torch.no_grad()``.  That eager pass is a real
run: its outputs answer the call that made the entry.  A later call
stages its inputs in the pinned buffers, copies them into the static
tensors and replays.  Tensors the function closes over (params, KV
arenas) are captured by address and must never be rebound.  Every graph
of one owner (an engine and its drafter) allocates from one memory pool
and replays on one thread, one at a time, so a graph's outputs are valid
only until the next replay: callers copy them to the host first.  A
capture that fails raises; nothing falls back to running eagerly.

Several owners (engines) may share one card and one process: captures
are serialized process-wide, run with garbage collection paused, and
use side streams of PyTorch's high-priority stream pool, so a capture
stream is never the stream another engine's worker replays on.

On the CPU (or with capture off) an entry is the eager function, run
once when it is made, as the warm pass; the bookkeeping is the same, so
the counts can be held against the JAX package's.

The kernels' launch counters (``bigdl_tpu_torch.ops.KERNELS``) tick in
Python, which a replay never reaches: each graph records the launches
its capture made on the capturing thread instead of counting them (a
capture runs nothing; another thread's launches meanwhile still count)
and adds them on every replay, so a counter reads the launches the
device ran.

Each entry made (a captured graph on the card, the eager function on
the CPU) files a row with the memory ledger under the cache's
``ledger_tag`` (``MemoryLedger.record_compiled``): the owner's graph-pool
bytes at that moment and no cost (no XLA cost analysis exists for a CUDA
graph); an LRU eviction releases the row.  A pool's standing bytes are
attributed once, by the engine that owns it, never per entry.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.quant.transform import (params_compute_tag,
                                             params_dtype_tag)

__all__ = ["CompileCache", "GraphPool", "StepGraph", "input_signature",
           "params_dtype_tag"]

Key = Tuple[tuple, str, Optional[str]]


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def input_signature(x) -> tuple:
    """The cache-key component for one input: ``(shape, dtype)`` for a
    single array, or for a dict of arrays its sorted keys plus each
    leaf's ``(shape, dtype)`` (two dicts with the same leaves under other
    names do not share an entry)."""
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return (tuple(int(n) for n in x.shape), _dtype_name(x.dtype))
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return (f"dict{keys}", tuple(input_signature(x[k]) for k in keys))
    raise TypeError(f"cache inputs are arrays or dicts of arrays, got "
                    f"{type(x).__name__}")


def _leaves(x):
    """(name, array) pairs of a single array (name None) or a flat dict."""
    if isinstance(x, dict):
        return [(k, np.asarray(x[k])) for k in sorted(x)]
    return [(None, np.asarray(x))]


def _pack(leaves, x_was_dict: bool):
    return dict(leaves) if x_was_dict else leaves[0][1]


def _ledger_row(tag: str, key: str, graphs: "GraphPool") -> None:
    """File one made entry's row with the memory ledger (best effort: the
    ledger never breaks a step)."""
    try:
        from bigdl_tpu_torch.obs.ledger import get_ledger
        get_ledger().record_compiled(tag, key, graphs)
    except Exception:
        pass


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A host tensor over ``a``, 0-d arrays kept 0-d."""
    return torch.from_numpy(np.asarray(a, order="C"))


def _on_device(x, device):
    return _pack([(k, _host_tensor(a).to(device)) for k, a in _leaves(x)],
                 isinstance(x, dict))


class _Eager:
    """An entry without capture: the function on freshly copied inputs."""

    def __init__(self, fn: Callable, device: torch.device):
        self._fn = fn
        self._device = device

    def __call__(self, x):
        with torch.no_grad():
            return self._fn(_on_device(x, self._device))


_CAPTURE_LOCK = threading.Lock()


@contextlib.contextmanager
def _gc_paused():
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class _Graph:
    """A captured entry: static inputs, pinned staging, the graph and
    references to its outputs."""

    def __init__(self, owner: "GraphPool", fn: Callable, x):
        from bigdl_tpu_torch.ops._build import recording_launches
        dev = owner.device
        self._owner = owner
        self._dict = isinstance(x, dict)
        leaves = _leaves(x)
        self._names = [k for k, _ in leaves]
        self._static = [torch.empty(a.shape, device=dev,
                                    dtype=_torch_dtype(a.dtype))
                        for _, a in leaves]
        self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                      for t in self._static]
        self._copied = torch.cuda.Event()
        self._stage(leaves)
        arg = _pack(list(zip(self._names, self._static)), self._dict)
        side = owner.stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), torch.cuda.stream(side):
            first = fn(arg)                 # the warm pass, a real run
        torch.cuda.current_stream(dev).wait_stream(side)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # one capture at a time in the process, and no garbage collection
        # inside one (a collected object's CUDA teardown must not land in
        # it); a capture launches nothing: its counts are kept for the
        # replays
        with _CAPTURE_LOCK, _gc_paused(), recording_launches() as rec, \
                torch.no_grad(), torch.cuda.graph(
                    graph, pool=owner.pool, stream=side,
                    capture_error_mode="thread_local"):
            self._out = fn(arg)
        self._deltas = list(rec.items())
        self._graph = graph
        self.first = first
        owner._captured(time.perf_counter() - t0)

    def _stage(self, leaves) -> None:
        # the previous copy out of the pinned buffers has to be done
        # before they are refilled
        self._copied.synchronize()
        for (_, a), host, static in zip(leaves, self._host, self._static):
            host.copy_(_host_tensor(a))
            static.copy_(host, non_blocking=True)
        self._copied.record()

    def __call__(self, x):
        leaves = _leaves(x)
        if [k for k, _ in leaves] != self._names or any(
                tuple(a.shape) != tuple(s.shape)
                for (_, a), s in zip(leaves, self._static)):
            raise ValueError("a captured graph replays the shapes it was "
                             "captured with")
        self._stage(leaves)
        self._graph.replay()
        for kernel, n in self._deltas:
            kernel.count(n)
        self._owner._replayed()
        return self._out


class GraphPool:
    """The graphs of one owner (an engine and its drafter): the memory
    pool and side stream they share, and counters of captures, replays
    and capture seconds.  ``capture=False`` (the only choice off a CUDA
    device) makes eager entries instead."""

    def __init__(self, device, capture: bool):
        self.device = torch.device(device)
        if capture and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got "
                             f"{self.device}")
        self.capture = bool(capture)
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        # captures run on a stream of the high-priority pool, which no
        # engine's worker stream (the default pool) can ever be
        self.stream = (torch.cuda.Stream(self.device, priority=-1)
                       if capture else None)
        self._lock = threading.Lock()
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def make(self, fn: Callable, x):
        """A new entry for ``fn(inputs)`` at ``x``'s shapes, and the
        outputs of its first (eager) run on ``x``."""
        if not self.capture:
            entry = _Eager(fn, self.device)
            return entry, entry(x)
        with torch.cuda.device(self.device):
            entry = _Graph(self, fn, x)
        first, entry.first = entry.first, None
        return entry, first

    def _captured(self, seconds: float) -> None:
        with self._lock:
            self.captures += 1
            self.capture_s += seconds

    def _replayed(self) -> None:
        with self._lock:
            self.replays += 1

    def pool_bytes(self) -> Optional[int]:
        """Device bytes the shared pool holds (None without capture, or
        when the allocator's snapshot does not name pools)."""
        if not self.capture:
            return None
        total, named = 0, False
        for seg in torch.cuda.memory_snapshot():
            if "segment_pool_id" in seg:
                named = True
                if tuple(seg["segment_pool_id"]) == tuple(self.pool):
                    total += int(seg["total_size"])
        return total if named else None

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.capture, "captures": self.captures,
                    "replays": self.replays, "capture_s": self.capture_s}


class StepGraph:
    """One fixed-shape step (decode, a verify width, the tree commit):
    the reference's single executable, made on first use from that
    call's inputs and replayed from then on.  ``compiles`` is the
    bounded-executables witness.  With a ``name`` the step files its
    memory-ledger row under ``(name, key)`` when made."""

    def __init__(self, fn: Callable, graphs: GraphPool, *,
                 name: Optional[str] = None, key: str = "step"):
        self._fn = fn
        self._graphs = graphs
        self._entry = None
        self.compiles = 0
        self.name = name
        self._key = key

    def __call__(self, x):
        if self._entry is None:
            self._entry, out = self._graphs.make(self._fn, x)
            self.compiles += 1
            if self.name is not None:
                _ledger_row(self.name, self._key, self._graphs)
            return out
        return self._entry(x)


class CompileCache:
    """Graph cache for ``fn(params, buffers, x) -> outputs``.

    ``params``/``buffers`` are the frozen model state (the same tensors
    every call, captured by address; only the params dtype tag is in
    the key); ``x`` is the padded input, one host array or a flat dict
    of them, whose per-leaf (shape, dtype) keys the entry.  ``name`` is
    the memory-ledger tag of its rows (default: the function's name).
    """

    def __init__(self, fn: Callable, *, graphs: GraphPool,
                 max_entries: int = 16, name: str = ""):
        self.ledger_tag = name or getattr(fn, "__name__", "fn").lstrip("_")
        self._fn = fn
        self._graphs = graphs
        self._max_entries = max(1, int(max_entries))
        self._entries: "OrderedDict[Key, Callable]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # ------------------------------------------------------------------ #
    def key_for(self, x, params=None) -> Key:
        if params is None:
            return (input_signature(x), "f32", None)
        return (input_signature(x), params_dtype_tag(params),
                params_compute_tag(params))

    @staticmethod
    def _ledger_key(key: Key) -> str:
        # input signature + params dtype tag, as the reference's rows
        return f"{key[0]}|{key[1]}"

    def _make(self, params, buffers, x):
        fn = self._fn
        made = self._graphs.make(lambda xs: fn(params, buffers, xs), x)
        _ledger_row(self.ledger_tag,
                    self._ledger_key(self.key_for(x, params)), self._graphs)
        return made

    def _admit(self, key: Key, entry: Callable, *, count: bool) -> bool:
        """Insert a freshly made entry under the LRU bound; returns
        whether it was new.  ``count`` toggles the miss counter (warmup
        provisioning is not traffic)."""
        evicted = []
        with self._lock:
            if count:
                self.misses += 1
            new = key not in self._entries
            if new:
                self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self._max_entries:
                evicted.append(self._entries.popitem(last=False)[0])
                self.evictions += 1
        if evicted:
            # keep the ledger's executable table in step with the LRU
            try:
                from bigdl_tpu_torch.obs.ledger import get_ledger
                led = get_ledger()
                for k in evicted:
                    led.release_executable(self.ledger_tag,
                                           self._ledger_key(k))
            except Exception:
                pass
        return new

    def __call__(self, params, buffers, x):
        """Run ``fn`` through the entry for x's shapes, making it (a
        miss) on first sight."""
        key = self.key_for(x, params)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self.hits += 1
                self._entries.move_to_end(key)
        if entry is not None:
            return entry(x)
        entry, out = self._make(params, buffers, x)
        self._admit(key, entry, count=True)
        return out

    # ------------------------------------------------------------------ #
    def warmup_inputs(self, params, buffers, inputs: Sequence) -> int:
        """Make an entry per example input (each an array or a flat dict
        of arrays) not cached yet; returns how many were made.  Warmup
        counts neither hits nor misses."""
        made = 0
        for x in inputs:
            key = self.key_for(x, params)
            with self._lock:
                present = key in self._entries
            if present:
                continue
            if self._admit(key, self._make(params, buffers, x)[0],
                           count=False):
                made += 1
        return made

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": (self.hits / total) if total else None,
                "ledger_tag": self.ledger_tag,
            }
