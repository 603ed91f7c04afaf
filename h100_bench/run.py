"""Run one cell of the benchmark of ``bigdl_tpu_torch`` on the H100.

    python3 h100_bench/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones (with the device's busy time
over the profiled slice, and the breakdown).  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, ``breakdown`` (traced runs), and ``checks``,
each compared number beside its limit; the checks are also the last
lines of standard error.  A run without the CUDA devices the cell asks
for, with a forbidden module loaded (``jax``, ``jaxlib``, ``flax``,
``bigdl_tpu``), or that fails, exits non-zero and prints no result.
"""
import time

T_PROCESS = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench.bench import common  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(cell, seed: int, seconds: float, trace: bool,
            device="cuda", t_start=None, kind=None) -> dict:
    """Run the cell and gather its result (``kind``: the card's name)."""
    run = cell.runner_module().run_cell(cell, seed, seconds, trace,
                                    device=device, t_start=t_start)
    metrics = {}
    if trace:
        ctx = run.context()
        for m in cell.metrics(trace=True):
            value = common.metric_reader(m["name"], cell.root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        e2e = run.end_to_end()
        for m in cell.metrics(trace=False):
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(run.memory_peak)}
    breakdown = None
    if trace:
        tr = run.devtrace
        if tr is not None and tr.t1 is not None:
            dev["busy_s"] = tr.busy_s()
            dev["window_s"] = tr.window_s
        breakdown = run.breakdown()
    return {"run": run, "correct": run.correct,
            "attempted": run.attempted(), "failed": run.failed(),
            "metrics": metrics, "device": dev, "breakdown": breakdown,
            "checks": run.check}


#: a run that has not ended by then prints every thread's stack and exits
#: non-zero: a run has 360 s (the first in a checkout, which builds, 1200)
DEADLINE_S = 340


def main(argv=None) -> int:
    args = parse(argv)
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    try:
        bench = common.load_benchmark(ROOT)
        cell = common.Cell(bench, args.workload, ROOT)
        kind = common.require_cuda(cell.chips)
        import torch
        print(f"[device] {kind} | count {cell.chips} of "
              f"{torch.cuda.device_count()} | nvidia-smi: "
              f"{common.nvidia_smi()} | torch {torch.__version__} "
              f"cuda {torch.version.cuda}", flush=True)
        out = measure(cell, args.seed, args.seconds, bool(args.trace),
                      t_start=T_PROCESS, kind=kind)
        common.check_imports()
    except Exception as e:  # noqa: BLE001 - the run's boundary
        traceback.print_exc()
        print(f"h100_bench: no result: {e}", file=sys.stderr, flush=True)
        return 1
    run = out["run"]
    common.log(f"[{cell.name}] seed {args.seed}: attempted "
               f"{out['attempted']}, failed {out['failed']}, reference "
               f"{getattr(run, 'reference_s', None)} s, metrics "
               f"{json.dumps(out['metrics'])}")
    for name, c in out["checks"].items():
        common.log(f"check {name}: {c['value']} (limit {c['limit']})")
    sys.stdout.flush()
    print(common.result_line(
        correct=out["correct"], attempted=out["attempted"],
        failed=out["failed"], metrics=out["metrics"], device=out["device"],
        breakdown=out["breakdown"], checks=out["checks"]), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # engine workers and stream readers are daemon threads that have
    # ended; leave without waiting on the interpreter's teardown
    os._exit(code)
