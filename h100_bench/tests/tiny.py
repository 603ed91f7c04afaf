"""A tiny copy of the benchmark's catalog for CPU tests: the real cell,
traffic and metric files with the sizes cut to what a test can hold."""
import json
import shutil
from pathlib import Path

from h100_bench.bench.common import ROOT

TINY = {"vocab_size": 97, "n_embd": 128, "n_head": 2, "n_layer": 2,
        "n_positions": 128, "n_ctx": 128}


def _edit(path: Path, fn) -> None:
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data))


def tiny_root(tmp: Path) -> Path:
    """A checkout-shaped directory holding ``BENCHMARK.json`` and the
    benchmark's data files, every cell pointed at a tiny configuration
    that keeps head_dim 64."""
    root = Path(tmp)
    bench_dir = root / "h100_bench"
    bench_dir.mkdir(parents=True)
    for d in ("cells", "traffic", "metrics", "configs", "runners"):
        shutil.copytree(ROOT / "h100_bench" / d, bench_dir / d)
    cfg = json.loads((ROOT / "h100_bench/configs/gpt2-small.json").read_text())
    cfg.update(TINY)
    (bench_dir / "configs/tiny.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "h100_bench/configs/tiny.json",
                             "reduced": [], "why": "tests"})
    for w in bench["workloads"]:
        w["config"] = "tiny"
    # the shared-document mix, kept for a later cell (h100_bench/cells/
    # and traffic/ hold it), runs here too
    if "xl-docqa-shared" not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append({"name": "xl-docqa-shared",
                                   "config": "tiny",
                                   "traffic": "docqa-shared", "chips": 1,
                                   "why": "tests"})
        # its end-to-end tail, and the readings of admission and prefill
        docqa = {"itl_p95_ms", "gen_lag_p95_ms", "queue_wait_p95_ms",
                 "prefix_hit_share", "prefill_mfu"}
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in docqa and "workloads" in m:
                m["workloads"].append("xl-docqa-shared")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    def serve_cell(c):
        c["engine"].update(cache_len=128, num_blocks=200, slots=8,
                           prefill_buckets=[16, 32, 64, 128])
        c["check"]["served_tokens"] = 40

    def train_cell(c):
        c["reference_rows"] = 2

    for path in (bench_dir / "cells").glob("*.json"):
        runner = json.loads(path.read_text())["runner"]
        _edit(path, serve_cell if runner == "serve" else train_cell)

    def chat(t):
        t.update(rate_rps=4.0, tail=dict(t["tail"], median=20, max=60),
                 output=dict(t["output"], median=8, min=2, max=16))

    def docqa(t):
        t.update(rate_rps=4.0, prefix=dict(t["prefix"], min=32, max=60),
                 tail=dict(t["tail"], min=4, max=10),
                 output=dict(t["output"], min=2, max=8),
                 ask_gap_s={"dist": "uniform", "min": 0.2, "max": 0.4})

    def train(t):
        t.update(batch=4, seq_len=32)

    _edit(bench_dir / "traffic/chat-poisson.json", chat)
    _edit(bench_dir / "traffic/docqa-shared.json", docqa)
    _edit(bench_dir / "traffic/train-32x1024.json", train)
    return root
