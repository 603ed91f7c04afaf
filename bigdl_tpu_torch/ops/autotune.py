"""Tile autotuning and the crossover cache for the attention kernels
(port of ``bigdl_tpu/ops/autotune.py``).

Measure the hand-written kernels against their plain alternatives on the
device actually attached, persist the winners per ``device_kind``, and
let the dispatchers consult the cache instead of a fixed rule.  Three
families are tuned:

* **flash train step**: sweeps the forward kernel's ``(block_q,
  block_k)`` tiles (``FLASH_TILES``) per ``(seq_len, head_dim, dtype,
  causal)``, timing forward + backward through autograd at each
  candidate, plus one row of the port's plain attention
  (``nn.attention.dot_product_attention``, impl ``naive_xla`` as the
  reference names its baseline).  The winner records the best tile and
  the crossover verdict ``use_flash`` (flash only where it measured
  faster than the plain core, or where the plain core could not run the
  shape at all).  The backward pair keeps its own tiles (64 keys for
  dK/dV, 64 queries for dQ): the tuned pair selects the forward's.
* **paged decode**: ``ops.paged_decode_attention`` against its dense
  ``arena[tables]`` gather per ``(head_dim, block_len, dtype)``, so
  ``LMServingEngine``'s ``decode_attn="auto"`` is measurement-backed.
* **qcompute duel**: ``quant.kernels.qmatmul_i8`` (per-token activation
  quantization, exact int32 accumulation, one float32 rescale) against
  the dequant product per ``(m, k, n)``, so ``compute="auto"`` resolves
  to int8 only where it measured faster.

Where the port differs from the reference:

* the device kind is ``torch.cuda.get_device_name`` of the device a
  sweep or lookup runs on, ``"cpu"`` on the host; the doc's
  ``platform`` is ``"gpu"`` or ``"cpu"`` (as ``platform_stamp`` names
  it) and its ``producer`` is ``"bigdl_tpu_torch"``.  A lookup needs all
  three to match, so a verdict the JAX package wrote (on the CPU its
  platform and device kind are ``"cpu"`` too) never steers the port;
* the cache is ``BIGDL_TPU_TORCH_TUNE_CACHE``, by default
  ``TUNE_CUDA.json`` at the repository root; it never reads
  ``TUNE_ATTN.json`` or ``BIGDL_TPU_TUNE_CACHE``;
* a sweep runs on the card unless ``device`` says otherwise; its inputs
  come from a seeded ``torch.Generator``; it times by CUDA events after
  a warm-up call on the card, behind a device-side sleep so that the
  host's launches are queued before the first event (device time, as
  the reference's one jitted dispatch is), by the host clock on the
  CPU;
* the flash grid is the forward kernel's tiles at the swept (dtype,
  head_dim) (:func:`default_grid`);
* a sticky CUDA error (an illegal address, a device-side assert) is
  never recorded as a row: it propagates, and no candidate follows;
* ``step_s`` keeps 7 decimals (0.1 us), not 5 or 6: the tiles of one
  kernel differ by microseconds;
* on a CUDA device a verdict picks the kernel's tile only: a
  ``use_flash`` or ``use_kernel`` of false is recorded, but the
  dispatchers launch the kernel all the same (the card never gives way
  to a plain version); the plain core or the gather wins a call only on
  the CPU.

The dispatchers (``use_flash_auto``, ``resolve_attention_plan``,
``resolve_compute``, the LM engine) memoize each verdict in this process
(:func:`memoized`) until :func:`clear_cache`, so a dispatch costs a dict
lookup, not a file stat; a sweep clears the memo after every flush.

The cache is a resumable measurement artifact: a row is flushed after
every candidate, ``complete`` stays false until the final flush, and a
rerun reuses only rows whose full identity (platform, device kind,
candidate key, batch/heads/iters) matches.  A rerun over a ``complete:
true`` doc for the same device does not touch the file until a candidate
actually re-measures.  Rows from other configs on the same device
accumulate across runs.
"""
from __future__ import annotations

import os
import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from bigdl_tpu_torch.ops.flash_attention import (FLASH_TILES, dtype_name,
                                                 flash_tiles)

#: the flash sweep's tiles by (dtype name, head_dim): the forward
#: kernel's own (``FLASH_TILES``), each (64, block_k)
DEFAULT_GRID = FLASH_TILES

#: the producer stamp a lookup requires of a doc
PRODUCER = "bigdl_tpu_torch"

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

# substrings that mark a candidate as impossible at this shape rather
# than transiently failed: such rows are reusable and count as a
# forfeit of the plain core in the crossover
_CAPACITY_PAT = ("out of memory", "OutOfMemoryError",
                 "too many resources requested", "shared memory")

# substrings of CUDA errors that poison the context: nothing measured
# after one is trustworthy, so the sweep stops and raises
_STICKY_PAT = ("illegal memory access", "illegal instruction",
               "misaligned address", "unspecified launch failure",
               "device-side assert", "hardware stack error",
               "invalid program counter", "uncorrectable ECC")


def _is_capacity_error(row) -> bool:
    err = row.get("error") or ""
    return any(p in err for p in _CAPACITY_PAT)


def _is_sticky(exc: BaseException) -> bool:
    msg = "%s: %s" % (type(exc).__name__, exc)
    return any(p in msg for p in _STICKY_PAT)


def _device(device=None) -> torch.device:
    """The device a lookup answers for: ``device``, or this process's
    default (the card when there is one)."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def _device_kind(device=None) -> str:
    dev = _device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        return torch.cuda.get_device_name(index)
    return "cpu"


def _platform(device=None) -> str:
    return "gpu" if _device(device).type == "cuda" else "cpu"


def cache_path() -> str:
    """``TUNE_CUDA.json`` at the repository root unless
    ``BIGDL_TPU_TORCH_TUNE_CACHE`` says otherwise (tests point it at tmp
    files)."""
    return (os.environ.get("BIGDL_TPU_TORCH_TUNE_CACHE")
            or os.path.join(_REPO_ROOT, "TUNE_CUDA.json"))


def attention_key(seq_len: int, head_dim: int, dtype, causal: bool) -> str:
    return "t%d_d%d_%s_%s" % (int(seq_len), int(head_dim),
                              dtype_name(dtype),
                              "causal" if causal else "full")


def paged_key(head_dim: int, block_len: int, dtype) -> str:
    return "paged_d%d_b%d_%s" % (int(head_dim), int(block_len),
                                 dtype_name(dtype))


def qcompute_key(m: int, k: int, n: int) -> str:
    return "qcompute_m%d_k%d_n%d" % (int(m), int(k), int(n))


def parse_grid(spec: str) -> Tuple[Tuple[int, int], ...]:
    """"64:32,64:64" -> ((64, 32), (64, 64))."""
    out = []
    for part in spec.split(","):
        bq, bk = part.strip().split(":")
        out.append((int(bq), int(bk)))
    return tuple(out)


def default_grid(dtype, head_dim: int) -> Tuple[Tuple[int, int], ...]:
    """The flash sweep's candidates at (dtype, head_dim): every tile the
    forward kernel takes there, by block_k."""
    return tuple(sorted(flash_tiles(dtype, head_dim), key=lambda p: p[1]))


# ---------------------------------------------------------------------------
# cache lookup (the dispatcher side)

_memo = {"key": None, "doc": None}
_verdicts: dict = {}


def clear_cache() -> None:
    """Drop the parsed doc and every memoized verdict (tests; after
    external writes)."""
    _memo["key"] = None
    _memo["doc"] = None
    _verdicts.clear()


def memoized(key, compute: Callable[[], object]):
    """``compute()``, kept per (``key``, cache path) until
    :func:`clear_cache`: the dispatchers' verdicts, so a dispatch on the
    per-step host path costs a dict lookup.  An exception is not kept."""
    full = (key, cache_path())
    try:
        return _verdicts[full]
    except KeyError:
        pass
    value = compute()
    _verdicts[full] = value
    return value


def device_key(device) -> tuple:
    """A hashable name of the device a lookup answers for."""
    dev = _device(device)
    return (dev.type, dev.index)


def load_cache(path: Optional[str] = None):
    """The parsed cache doc, memoized on (path, mtime, size)."""
    path = path or cache_path()
    try:
        st = os.stat(path)
    except OSError:
        return None
    key = (path, st.st_mtime_ns, st.st_size)
    if _memo["key"] == key:
        return _memo["doc"]
    from bigdl_tpu_torch.utils.artifacts import load_artifact
    doc = load_artifact(path)
    _memo["key"] = key
    _memo["doc"] = doc
    return doc


def _ours(doc, device=None) -> bool:
    """Whether ``doc`` holds verdicts for the attached device: written by
    this package, on this platform, for this device kind."""
    return (isinstance(doc, dict) and doc.get("producer") == PRODUCER
            and doc.get("platform") == _platform(device)
            and doc.get("device_kind") == _device_kind(device))


class TunedAttention(NamedTuple):
    block_q: Optional[int]
    block_k: Optional[int]
    use_flash: Optional[bool]  # None: no plain-core baseline measured yet
    flash_step_s: Optional[float]
    xla_step_s: Optional[float]


class TunedPagedDecode(NamedTuple):
    use_kernel: Optional[bool]
    kernel_step_s: Optional[float]
    gather_step_s: Optional[float]


def lookup(seq_len: int, head_dim: int, dtype, causal: bool,
           *, path: Optional[str] = None,
           device=None) -> Optional[TunedAttention]:
    """Tuned winner for one flash config, or None when the cache has no
    verdict for the device ``device`` names (a cache tuned on another
    card, or on the CPU, never steers this one)."""
    doc = load_cache(path)
    if not _ours(doc, device):
        return None
    w = (doc.get("winners") or {}).get(
        attention_key(seq_len, head_dim, dtype, causal))
    if not isinstance(w, dict):
        return None
    return TunedAttention(w.get("block_q"), w.get("block_k"),
                          w.get("use_flash"),
                          w.get("flash_step_s"), w.get("xla_step_s"))


def lookup_paged(head_dim: int, block_len: int, dtype,
                 *, path: Optional[str] = None,
                 device=None) -> Optional[TunedPagedDecode]:
    """Tuned kernel-vs-gather verdict for paged decode attention."""
    doc = load_cache(path)
    if not _ours(doc, device):
        return None
    w = (doc.get("winners") or {}).get(paged_key(head_dim, block_len, dtype))
    if not isinstance(w, dict):
        return None
    return TunedPagedDecode(w.get("use_kernel"),
                            w.get("kernel_step_s"), w.get("gather_step_s"))


def lookup_qcompute(m: int, k: int, n: int,
                    *, path: Optional[str] = None,
                    device=None) -> Optional[str]:
    """Measured winner of the int8-compute-vs-dequant duel for an ``(m,
    k, n)`` product on the device: "int8", "dequant", or None when there
    is no verdict.  An exact (m, k, n) entry wins; otherwise the verdict
    of the largest-m entry with the same (k, n) applies (m is the token
    batch, which varies run to run; (k, n) is the layer geometry)."""
    doc = load_cache(path)
    if not _ours(doc, device):
        return None
    winners = doc.get("winners") or {}
    w = winners.get(qcompute_key(m, k, n))
    if isinstance(w, dict) and w.get("use_int8") is not None:
        return "int8" if w["use_int8"] else "dequant"
    best = None
    for entry in winners.values():
        if (isinstance(entry, dict) and entry.get("qcompute")
                and entry.get("k") == int(k) and entry.get("n") == int(n)
                and entry.get("use_int8") is not None):
            if best is None or entry.get("m", 0) > best.get("m", 0):
                best = entry
    if best is None:
        return None
    return "int8" if best["use_int8"] else "dequant"


# ---------------------------------------------------------------------------
# winner recomputation (from ALL rows, every flush)

def _row_key(r) -> tuple:
    if r.get("kind") == "qcompute":
        return ("qcompute", r.get("impl"), r.get("m"), r.get("k"),
                r.get("n"))
    if r.get("kind") == "paged_decode":
        return ("paged_decode", r.get("impl"), r.get("slots"),
                r.get("heads"), r.get("head_dim"), r.get("cache_len"),
                r.get("block_len"), r.get("dtype"))
    return ("train_step", r.get("impl"), r.get("seq_len"),
            r.get("head_dim"), r.get("dtype"),
            bool(r.get("causal", True)), r.get("block_q"), r.get("block_k"))


def _fastest_by_impl(rs) -> dict:
    by = {}
    for r in rs:
        if "step_s" in r:
            prev = by.get(r.get("impl"))
            if prev is None or r["step_s"] < prev:
                by[r.get("impl")] = r["step_s"]
    return by


def _recompute_winners(rows) -> dict:
    winners = {}
    att, paged, qcomp = {}, {}, {}
    for r in rows:
        if not isinstance(r, dict):
            continue
        if r.get("kind") == "qcompute":
            cfg = (r.get("m"), r.get("k"), r.get("n"))
            qcomp.setdefault(cfg, []).append(r)
        elif r.get("kind") == "paged_decode":
            cfg = (r.get("head_dim"), r.get("block_len"), r.get("dtype"))
            paged.setdefault(cfg, []).append(r)
        elif r.get("kind") == "train_step":
            cfg = (r.get("seq_len"), r.get("head_dim"), r.get("dtype"),
                   bool(r.get("causal", True)))
            att.setdefault(cfg, []).append(r)
    for (t, d, dt, causal), rs in sorted(att.items(), key=str):
        flash = [r for r in rs if r.get("impl") == "flash" and "step_s" in r]
        xla = [r for r in rs if r.get("impl") == "naive_xla"
               and "step_s" in r]
        xla_forfeit = any(r.get("impl") == "naive_xla"
                          and _is_capacity_error(r) for r in rs)
        entry = {"seq_len": t, "head_dim": d, "dtype": dt, "causal": causal}
        if flash:
            best = min(flash, key=lambda r: r["step_s"])
            entry["block_q"] = best.get("block_q")
            entry["block_k"] = best.get("block_k")
            entry["flash_step_s"] = best["step_s"]
        if xla:
            entry["xla_step_s"] = min(r["step_s"] for r in xla)
        if flash and xla:
            entry["use_flash"] = entry["flash_step_s"] < entry["xla_step_s"]
            entry["flash_speedup_vs_xla"] = round(
                entry["xla_step_s"] / entry["flash_step_s"], 4)
        elif flash and xla_forfeit:
            entry["use_flash"] = True  # the plain core cannot run the shape
        else:
            entry["use_flash"] = None
        winners[attention_key(t, d, dt, causal)] = entry
    for (d, bl, dt), rs in sorted(paged.items(), key=str):
        by = _fastest_by_impl(rs)
        entry = {"head_dim": d, "block_len": bl, "dtype": dt}
        kern, gath = by.get("paged_kernel"), by.get("dense_gather")
        if kern is not None:
            entry["kernel_step_s"] = kern
        if gath is not None:
            entry["gather_step_s"] = gath
        if kern is not None and gath is not None:
            entry["use_kernel"] = kern < gath
            entry["kernel_speedup_vs_gather"] = round(gath / kern, 4)
        else:
            entry["use_kernel"] = None
        winners[paged_key(d, bl, dt)] = entry
    for (m, k, n), rs in sorted(qcomp.items(), key=str):
        by = _fastest_by_impl(rs)
        entry = {"qcompute": True, "m": m, "k": k, "n": n}
        i8, dq = by.get("int8_compute"), by.get("dequant_bf16")
        if i8 is not None:
            entry["int8_step_s"] = i8
        if dq is not None:
            entry["dequant_step_s"] = dq
        if i8 is not None and dq is not None:
            # strict <: a tie keeps the baseline (auto never loses)
            entry["use_int8"] = i8 < dq
            entry["int8_speedup_vs_dequant"] = round(dq / i8, 4)
        else:
            entry["use_int8"] = None
        winners[qcompute_key(m, k, n)] = entry
    return winners


# ---------------------------------------------------------------------------
# measurement

#: device clock cycles queued ahead of a timed loop (about 0.1 s on an
#: H100): the host enqueues every timed call before the device reaches
#: the first event, so the time is the device's, not the host's launches
_LEAD_CYCLES = 200_000_000


def _timed(call, iters: int, device: torch.device) -> float:
    """Mean seconds per ``call()`` after one warm-up call: by CUDA events
    around ``iters`` calls on the card, behind a device-side sleep; by
    the host clock on the CPU."""
    call()
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_LEAD_CYCLES)
            start.record()
            for _ in range(iters):
                call()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    return (time.perf_counter() - t0) / iters


def _train_step_time(fn, q, k, v, iters: int) -> float:
    """Mean seconds per forward + backward step through autograd."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

    def step():
        with torch.enable_grad():
            out = fn(*leaves).float().sum()
            return torch.autograd.grad(out, leaves)

    return _timed(step, iters, q.device)


def _op_step_time(fn, args, iters: int) -> float:
    def call():
        with torch.no_grad():
            return fn(*args)

    return _timed(call, iters, args[0].device)


def _measure_into(row: dict, step: Callable[[], float], tokens: int,
                  digits: int) -> dict:
    """Time ``step`` into ``row``: ``step_s`` and ``tokens_per_s``, or
    ``error`` for a candidate that failed (recorded; the sweep goes on).
    A sticky CUDA error propagates."""
    try:
        step_s = step()
        row["step_s"] = round(step_s, digits)
        if tokens:
            row["tokens_per_s"] = round(tokens / step_s, 1)
    except Exception as e:  # noqa: BLE001 -- recorded, sweep continues
        if _is_sticky(e):
            raise
        row["error"] = ("%s: %s" % (type(e).__name__, e))[:500]
    return row


def _run_sweep(cands, measure, run_match, *, path, finalize, log, device):
    """Shared resumable candidate loop: reuse identity-matched prior
    rows, re-measure the rest, flush the artifact (rows + recomputed
    winners) after EVERY candidate so a killed sweep resumes, except
    that a certified complete doc is never rewritten before the first
    genuinely new measurement lands."""
    from bigdl_tpu_torch.utils.artifacts import load_artifact, write_artifact
    plat, kind = _platform(device), _device_kind(device)
    cand_keys = {_row_key(c) for c in cands}
    base_rows, reuse = [], {}
    prev = load_artifact(path)
    mine = _ours(prev, device)
    if mine:
        for r in prev.get("rows") or []:
            if not isinstance(r, dict):
                continue
            key = _row_key(r)
            if key not in cand_keys:
                base_rows.append(r)  # other configs: accumulated cache
            elif run_match(r) and ("step_s" in r or _is_capacity_error(r)):
                reuse[key] = r

    done = []

    def snapshot(complete):
        rows = base_rows + done
        return {"metric": "attention_block_autotune", "producer": PRODUCER,
                "platform": plat, "device": str(device),
                "device_kind": kind, "rows": rows,
                "winners": _recompute_winners(rows),
                "complete": bool(complete)}

    def flush(complete):
        doc = snapshot(complete)
        write_artifact(path, doc)
        clear_cache()
        return doc

    # a certified complete doc for this device is left untouched until a
    # candidate actually re-measures: an all-reuse rerun, or one killed
    # before any new row lands, must not regress it to complete: false
    certified = mine and prev.get("complete") is True
    if not certified:
        flush(False)
    for cand in cands:
        key = _row_key(cand)
        if key in reuse:
            row = dict(reuse[key])
            row["reused_from_previous_run"] = True
        else:
            row = measure(cand)
            certified = False  # new data: the old doc no longer covers it
        done.append(row)
        log("tune: %s" % {k: v for k, v in row.items() if k != "kind"})
        if not certified:
            flush(False)
    return snapshot(True) if certified else flush(finalize)


def _resolve(device) -> torch.device:
    from bigdl_tpu_torch.device import resolve_device
    return resolve_device(device)


def autotune_attention(seq_lens: Sequence[int], *, head_dim: int = 128,
                       dtype="bfloat16", causal: bool = True,
                       batch: int = 1, heads: int = 8, iters: int = 3,
                       grid: Optional[Sequence[Tuple[int, int]]] = None,
                       path: Optional[str] = None, finalize: bool = True,
                       log=print, device=None) -> dict:
    """Sweep the forward's (block_q, block_k) tiles per seq_len (``grid``,
    by default :func:`default_grid`), plus one plain-core row each,
    persisting winners and crossover verdicts into the tuning cache.
    Returns the final artifact doc."""
    dev = _resolve(device)
    path = path or cache_path()
    dtype = dtype_name(dtype)
    grid = default_grid(dtype, head_dim) if grid is None else tuple(grid)
    ident = {"head_dim": int(head_dim), "dtype": dtype,
             "causal": bool(causal), "batch": int(batch),
             "heads": int(heads), "iters": int(iters)}
    cands = []
    for t in seq_lens:
        for bq, bk in grid:
            cands.append(dict(kind="train_step", impl="flash",
                              seq_len=int(t), block_q=int(bq),
                              block_k=int(bk), **ident))
        cands.append(dict(kind="train_step", impl="naive_xla",
                          seq_len=int(t), block_q=0, block_k=0, **ident))

    def run_match(r):
        return (r.get("batch") == batch and r.get("heads") == heads
                and r.get("iters") == iters)

    def measure(cand):
        shape = (batch, heads, cand["seq_len"], head_dim)
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(
            getattr(torch, dtype)) for _ in range(3))
        if cand["impl"] == "flash":
            from bigdl_tpu_torch.ops.flash_attention import flash_attention
            # explicit blocks pin the kernel: the tuner is never rerouted
            # by the crossover it is measuring for
            fn = lambda q, k, v: flash_attention(  # noqa: E731
                q, k, v, causal=causal,
                block_q=cand["block_q"], block_k=cand["block_k"])
        else:
            from bigdl_tpu_torch.nn.attention import dot_product_attention
            fn = lambda q, k, v: dot_product_attention(  # noqa: E731
                q, k, v, causal=causal)
        return _measure_into(
            dict(cand), lambda: _train_step_time(fn, q, k, v, iters),
            batch * cand["seq_len"], 7)

    return _run_sweep(cands, measure, run_match, path=path,
                      finalize=finalize, log=log, device=dev)


def autotune_paged_decode(*, slots: int = 8, heads: int = 8,
                          head_dim: int = 128, cache_len: int = 2048,
                          block_len: int = 16, dtype="bfloat16",
                          iters: int = 20, path: Optional[str] = None,
                          finalize: bool = True, log=print,
                          device=None) -> dict:
    """Time the paged-decode kernel against the dense ``arena[tables]``
    gather at one serving shape (every slot at its last position) and
    persist the use_kernel verdict."""
    from bigdl_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)
    dev = _resolve(device)
    path = path or cache_path()
    dtype = dtype_name(dtype)
    width = -(-cache_len // block_len)
    num_blocks = slots * width + 1  # + the scratch block
    ident = {"slots": int(slots), "heads": int(heads),
             "head_dim": int(head_dim), "cache_len": int(cache_len),
             "block_len": int(block_len), "dtype": dtype,
             "iters": int(iters)}
    cands = [dict(kind="paged_decode", impl="paged_kernel", **ident),
             dict(kind="paged_decode", impl="dense_gather", **ident)]

    def run_match(r):
        return r.get("iters") == iters

    tdt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((slots, heads, head_dim), generator=g,
                    device=dev).to(tdt)
    ka = torch.randn((num_blocks, heads, block_len, head_dim), generator=g,
                     device=dev).to(tdt)
    va = torch.randn(ka.shape, generator=g, device=dev).to(tdt)
    tables = torch.arange(1, slots * width + 1, dtype=torch.int32,
                          device=dev).reshape(slots, width)
    pos = torch.full((slots,), cache_len - 1, dtype=torch.int32, device=dev)
    fns = {"paged_kernel": paged_decode_attention,
           "dense_gather": paged_decode_attention_reference}

    def measure(cand):
        fn = fns[cand["impl"]]
        return _measure_into(
            dict(cand),
            lambda: _op_step_time(fn, (q, ka, va, tables, pos), iters),
            0, 7)

    return _run_sweep(cands, measure, run_match, path=path,
                      finalize=finalize, log=log, device=dev)


#: default (m, k, n) duel shapes: decode-row (m=slots) and prefill-tile
#: (m=tokens) activations against serving-scale layer geometries
DEFAULT_QCOMPUTE_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (8, 1024, 1024), (8, 1024, 4096),
    (256, 1024, 1024), (256, 1024, 4096),
)


def autotune_qcompute(shapes: Sequence[Tuple[int, int, int]]
                      = DEFAULT_QCOMPUTE_SHAPES, *, iters: int = 20,
                      path: Optional[str] = None, finalize: bool = True,
                      log=print, device=None) -> dict:
    """The int8-compute-vs-dequant duel: per (m, k, n), time
    ``qmatmul_i8`` against ``qmatmul`` on a dequant-mode QTensor (the
    storage-only recipe).  Winners persist per device kind;
    ``compute="auto"`` resolves through :func:`lookup_qcompute`, so auto
    never loses to dequant."""
    from bigdl_tpu_torch.quant.kernels import qmatmul, qmatmul_i8
    from bigdl_tpu_torch.quant.qtensor import quantize_array
    dev = _resolve(device)
    path = path or cache_path()
    cands = []
    for m, k, n in shapes:
        ident = {"m": int(m), "k": int(k), "n": int(n), "iters": int(iters)}
        cands.append(dict(kind="qcompute", impl="int8_compute", **ident))
        cands.append(dict(kind="qcompute", impl="dequant_bf16", **ident))

    def run_match(r):
        return r.get("iters") == iters

    fns = {"int8_compute": qmatmul_i8, "dequant_bf16": qmatmul}

    def measure(cand):
        m, k, n = cand["m"], cand["k"], cand["n"]
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((m, k), generator=g, device=dev)
        w = torch.randn((k, n), generator=g, device=dev)
        qw = quantize_array(w, (0,),
                            compute="int8" if cand["impl"] == "int8_compute"
                            else "dequant")
        fn = fns[cand["impl"]]
        return _measure_into(
            dict(cand), lambda: _op_step_time(fn, (x, qw), iters), m, 7)

    return _run_sweep(cands, measure, run_match, path=path,
                      finalize=finalize, log=log, device=dev)
