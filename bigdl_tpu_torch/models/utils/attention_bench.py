"""Attention benchmark and the tile sweep's entry point (port of
``bigdl_tpu/models/utils/attention_bench.py``).

    python -m bigdl_tpu_torch.models.utils.attention_bench -t 1024 -b 8 \
        --heads 12 --headDim 64 --naive
    python -m bigdl_tpu_torch.models.utils.attention_bench --autotune \
        --sweep 1024 -b 8 --heads 12 --headDim 64 --dtype bfloat16 \
        --json TUNE_CUDA.json

Prints one JSON line per (impl, T): the causal train-step time (forward
+ backward through autograd) at (B, H, T, D); ``--naive`` also times
the port's plain attention, so the crossover is visible; ``--segmented``
times flash with packed-document segment ids.  ``--json`` writes every
row and the per-T flash/plain speedup into one resumable document
(rewritten after every row; a rerun reuses the same-config rows), with
the platform stamp.  A config that runs out of memory reports {"error":
...} instead of ending the sweep.

``--autotune`` runs ``ops.autotune.autotune_attention`` at each length
(``-t`` or ``--sweep``) over ``--tuneGrid`` (by default every tile the
forward kernel takes at the dtype and head width) plus the plain row:
the doc it writes to ``--json`` is a tuning cache, the file the
dispatchers read when ``BIGDL_TPU_TORCH_TUNE_CACHE`` names it (or when
it is ``TUNE_CUDA.json`` at the repository root).  ``--useTuned`` takes
each length's flash tile from that cache instead of ``--blockQ/
--blockK``.  Nothing is written unless ``--json`` names a file.  The
bench runs on the card unless ``--device cpu`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile


def bench_one(impl: str, seq_len: int, batch: int, heads: int,
              head_dim: int, dtype: str, iters: int = 5,
              block_q=None, block_k=None, segmented: bool = False,
              device=None) -> dict:
    """One train-step row: ``impl`` "flash" (pinned at (block_q,
    block_k), the default tile when None) or the plain core."""
    import numpy as np
    import torch

    from bigdl_tpu_torch.device import resolve_device
    from bigdl_tpu_torch.nn.attention import dot_product_attention
    from bigdl_tpu_torch.ops import autotune, flash_attention, flash_tiles

    dev = resolve_device(device)
    if block_q is None or block_k is None:
        dq, dk = flash_tiles(dtype, head_dim)[0]
        block_q, block_k = block_q or dq, block_k or dk
    shape = (batch, heads, seq_len, head_dim)
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(
        getattr(torch, dtype)) for _ in range(3))
    seg = None
    if segmented:
        # about 8 packed documents a window: the isolation-overhead arm
        rng = np.random.RandomState(0)
        seg = torch.tensor(np.sort(rng.randint(0, 8, (batch, seq_len))),
                           dtype=torch.int32, device=dev)
    if impl == "flash":
        def fn(q, k, v):
            return flash_attention(q, k, v, causal=True, segment_ids=seg,
                                   block_q=block_q, block_k=block_k)
    else:
        def fn(q, k, v):
            return dot_product_attention(q, k, v, causal=True)
    row = {"metric": "flash_causal_train_step", "impl": impl,
           "seq_len": seq_len, "batch": batch, "heads": heads,
           "head_dim": head_dim, "dtype": dtype, "segmented": segmented,
           "block_q": int(block_q), "block_k": int(block_k), "iters": iters}
    return autotune._measure_into(
        row, lambda: autotune._train_step_time(fn, q, k, v, iters),
        batch * seq_len, 7)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Flash-attention train-step "
                                            "bench")
    p.add_argument("-t", "--seqLen", type=int, default=1024)
    p.add_argument("--sweep", default=None,
                   help="comma-separated seq lens; overrides --seqLen")
    p.add_argument("-b", "--batch", type=int, default=1)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--headDim", type=int, default=64)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--blockQ", type=int, default=None,
                   help="flash query tile (default: the kernel's default "
                        "tile)")
    p.add_argument("--blockK", type=int, default=None,
                   help="flash key tile (default: the kernel's default "
                        "tile)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--naive", action="store_true",
                   help="also time the plain attention core")
    p.add_argument("--segmented", action="store_true",
                   help="also time flash with packed-document segment ids")
    p.add_argument("--autotune", action="store_true",
                   help="sweep the forward's tiles plus the plain row at "
                        "each length into the tuning doc at --json")
    p.add_argument("--tuneGrid", default=None,
                   help="comma list of blockQ:blockK pairs for --autotune "
                        "(default: every tile the kernel takes at "
                        "--dtype/--headDim)")
    p.add_argument("--useTuned", action="store_true",
                   help="resolve each length's flash tile from the tuning "
                        "cache (BIGDL_TPU_TORCH_TUNE_CACHE, default "
                        "TUNE_CUDA.json) instead of --blockQ/--blockK")
    p.add_argument("--json", default=None,
                   help="write the document to this path")
    p.add_argument("--require-lens", default=None,
                   help="comma list of seq_lens the document must cover "
                        "(per impl) before it is marked complete")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from bigdl_tpu_torch.device import resolve_device
    from bigdl_tpu_torch.ops import autotune, flash_tiles
    from bigdl_tpu_torch.utils.artifacts import platform_stamp

    dev = resolve_device(args.device)
    seq_lens = ([int(s) for s in args.sweep.split(",")]
                if args.sweep else [args.seqLen])
    if args.autotune:
        _autotune(args, seq_lens, dev)
        return
    plat = "gpu" if dev.type == "cuda" else "cpu"
    # per-T flash tile plan: the CLI blocks, or the autotuned winners
    # (--useTuned; a length without a verdict keeps the CLI blocks)
    plan = {}
    for t in seq_lens:
        bq, bk = args.blockQ, args.blockK
        if bq is None or bk is None:
            dq, dk = flash_tiles(args.dtype, args.headDim)[0]
            bq, bk = bq or dq, bk or dk
        if args.useTuned:
            e = autotune.lookup(t, args.headDim, args.dtype, True,
                                device=dev)
            if e is not None and e.block_q:
                bq, bk = int(e.block_q), int(e.block_k or e.block_q)
        plan[t] = (bq, bk)
    # resume: reuse the successful same-config rows of a killed sweep;
    # rows of another platform or iteration count never qualify
    from bigdl_tpu_torch.utils.artifacts import (load_artifact,
                                                 load_resumable_rows,
                                                 write_artifact)
    prev = load_resumable_rows(
        args.json,
        match=lambda old, r: (
            old.get("platform") == plat and "step_s" in r
            and r.get("batch") == args.batch
            and r.get("heads") == args.heads
            and r.get("head_dim") == args.headDim
            and r.get("dtype") == args.dtype
            and (r.get("block_q"), r.get("block_k"))
            == plan.get(r.get("seq_len"))
            and r.get("iters") == args.iters),
        key=lambda r: (r.get("seq_len"), r.get("impl")))
    impls = ["flash"]
    if args.naive:
        impls.append("naive_xla")
    if args.segmented:
        impls.append("flash_segmented")
    # carry-forward: same-platform rows outside this invocation's sweep
    # survive the rewrite (per-length firings share one document)
    mine = {(t, impl) for t in seq_lens for impl in impls}
    old_doc = load_artifact(args.json) or {}
    rows = [r for r in (old_doc.get("rows") or [])
            if isinstance(r, dict) and old_doc.get("platform") == plat
            and (r.get("seq_len"), r.get("impl")) not in mine]
    result = {"platform": plat, "device": str(dev), "rows": rows,
              "complete": False}

    def flush():
        summary = _summarize(rows)
        if summary:
            result["summary"] = summary
        result.update(platform_stamp(dev))
        write_artifact(args.json, result)

    for t in seq_lens:
        for impl in impls:
            if (t, impl) in prev:
                row = dict(prev[(t, impl)], reused_from_previous_run=True)
            else:
                row = bench_one(
                    "flash" if impl.startswith("flash") else "naive",
                    t, args.batch, args.heads, args.headDim, args.dtype,
                    iters=args.iters, block_q=plan[t][0],
                    block_k=plan[t][1],
                    segmented=impl == "flash_segmented", device=dev)
                row["impl"] = impl
                row.update(platform_stamp(dev))
            rows.append(row)
            flush()
            print(json.dumps(row), flush=True)
    # complete certifies the full comparison: the plain baseline
    # measured, and every required length covered (a capacity error is
    # a measurement, so it covers its length)
    require = ([int(s) for s in args.require_lens.split(",")]
               if args.require_lens else list(seq_lens))
    have = {(r.get("seq_len"), r.get("impl")) for r in rows
            if "step_s" in r or autotune._is_capacity_error(r)}
    result["complete"] = bool(args.naive) and all(
        (t, impl) in have for t in require for impl in impls)
    flush()


def _autotune(args, seq_lens, dev) -> None:
    """The tile sweep into the tuning doc at --json (into a temporary
    file, removed, without it): resumable, a row flushed after every
    candidate; prints every row and each length's winner."""
    from bigdl_tpu_torch.ops import autotune
    from bigdl_tpu_torch.utils.artifacts import platform_stamp
    grid = (autotune.parse_grid(args.tuneGrid) if args.tuneGrid
            else autotune.default_grid(args.dtype, args.headDim))

    def run(path):
        doc = autotune.autotune_attention(
            seq_lens, head_dim=args.headDim, dtype=args.dtype, causal=True,
            batch=args.batch, heads=args.heads, iters=args.iters, grid=grid,
            path=path, log=lambda *_: None, device=dev)
        for r in doc["rows"]:
            print(json.dumps(r), flush=True)
        for t in seq_lens:
            key = autotune.attention_key(t, args.headDim, args.dtype, True)
            print(json.dumps({"winner": key, **doc["winners"].get(key, {}),
                              **platform_stamp(dev)}), flush=True)

    if args.json:
        run(args.json)
        return
    with tempfile.TemporaryDirectory() as tmp:
        run(os.path.join(tmp, "tune.json"))
        autotune.clear_cache()


def _summarize(rows) -> list:
    """Per-T flash-vs-plain crossover summary, from the fastest flash
    row at each T, with its tile."""
    by_t = {}
    for r in rows:
        cur = by_t.setdefault(r["seq_len"], {})
        best = cur.get(r["impl"])
        if (best is None or ("step_s" in r
                             and ("step_s" not in best
                                  or r["step_s"] < best["step_s"]))):
            cur[r["impl"]] = r
    summary = []
    for t in sorted(by_t):
        pair = by_t[t]
        entry = {"seq_len": t}
        f, n = pair.get("flash"), pair.get("naive_xla")
        if f and "step_s" in f:
            entry["block_q"] = f.get("block_q")
            entry["block_k"] = f.get("block_k")
        if f and "step_s" in f and n and "step_s" in n:
            entry["flash_speedup_vs_xla"] = round(n["step_s"] / f["step_s"], 3)
        elif f and "step_s" in f and n and "error" in n:
            entry["flash_speedup_vs_xla"] = "inf (plain failed: capacity)"
        s = pair.get("flash_segmented")
        if f and "step_s" in f and s and "step_s" in s:
            entry["segmented_overhead_vs_flash"] = round(
                s["step_s"] / f["step_s"], 3)
        summary.append(entry)
    return summary


if __name__ == "__main__":
    main()
