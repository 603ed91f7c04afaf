"""Find a serving cell's knee on the card: the highest offered rate at
which completions keep pace with arrivals and nothing is shed.

    python3 h100_bench/sweep.py --workload <cell> --seconds <s> \\
        --seed <n> [--start 2] [--bisect 3]

One engine (the cell's, built once) serves the cell's mix at one rate
after another: doubling from ``--start`` until a rate fails, then
``--bisect`` halvings of the interval between the last rate that held
and the first that failed.  A rate holds when no request is shed and
the queue does not grow: the requests waiting for their first token
(submitted, no token yet), read at 20 instants of each quarter of the
window, average no more over the last quarter than over the second,
give or take one request.  Below capacity a request waits only for the
prefills ahead of it and the queue stays near empty however long the
window; past it, the slots are full and the queue grows for as long as
the rate lasts.  Each rate's line gives the offered rate, requests due,
completed, shed, the queue over the second and the last quarter, the
requests in flight at the close, the tails of TTFT and ITL, and the
tokens a second completed; the last line the knee and 0.8 of it
rounded down to 0.5 requests/s.  Requests still open a drain's length
after the close are cancelled before the next rate.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench.bench import common  # noqa: E402


def backlog(records, at: float) -> int:
    """Requests submitted by ``at`` and not finished by then."""
    n = 0
    for r in records:
        if r.submitted is not None and r.submitted <= at:
            if not (r.finished and r.times[-1] <= at):
                n += 1
    return n


def waiting(records, at: float) -> int:
    """Requests submitted by ``at`` without a first token by then."""
    return sum(1 for r in records
               if r.submitted is not None and r.submitted <= at
               and not (r.times and r.times[0] <= at))


def queue_mean(records, t0: float, seconds: float, quarter: int) -> float:
    """The mean queue over a quarter (1 to 4) of the window."""
    at = [t0 + seconds * (quarter - 1 + (i + 0.5) / 20) / 4
          for i in range(20)]
    return sum(waiting(records, a) for a in at) / len(at)


def one_rate(run, rate: float, seconds: float, seed: int) -> dict:
    """Serve ``rate`` for ``seconds`` on the warm engine of ``run``."""
    import torch
    prefix_pairs = run.cell.runner_module().prefix_pairs
    run.rate, run.seed = rate, seed
    run.requests = run.schedule(seed, seconds, rate)
    suffix, blocks = prefix_pairs(run.requests, run.engine.block_len)
    if suffix:
        run.engine.warmup_prefix(suffix, blocks)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.records = []
    run.window_run(close_engine=False)
    t0, close = run.window
    for r in run.records:
        if r.stream is not None and not r.stream.done():
            r.stream.cancel()
    for r in run.records:
        r.ended.wait(30.0)
    while True:   # the engine idles before the next rate
        st = run.engine.stats()
        if not st["active"] and not st["queued"] and not st["prefilling"]:
            break
        time.sleep(0.05)
    done = [r for r in run.records if r.finished]
    toks = sum(len(r.tokens) for r in run.records)
    early = queue_mean(run.records, t0, seconds, 2)
    late = queue_mean(run.records, t0, seconds, 4)
    shed = sum(1 for r in run.records if r.shed)
    e2e = run.end_to_end()
    return {"offered_rps": rate, "due": len(run.records),
            "completed": len(done), "shed": shed, "queue_q2": early,
            "queue_q4": late, "in_flight_close": backlog(run.records, close),
            "holds": shed == 0 and late <= early + 1.0,
            "ttft_p95_ms": e2e["ttft_p95_ms"],
            "itl_p95_ms": e2e["itl_p95_ms"],
            "tokens_per_s": toks / (close - t0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--start", type=float, default=2.0)
    ap.add_argument("--bisect", type=int, default=3)
    args = ap.parse_args(argv)
    cell = common.Cell(common.load_benchmark(ROOT), args.workload, ROOT)
    common.require_cuda(cell.chips)
    print(f"[device] {common.nvidia_smi()}", flush=True)
    run = cell.runner_module().Run(cell, args.seed, args.seconds, False,
                                   rate_rps=args.start)
    run.settings = dict(run.settings, drain_limit_s=20.0)
    run.setup()
    rows = []

    def probe(rate):
        row = one_rate(run, rate, args.seconds, args.seed + len(rows))
        rows.append(row)
        print(json.dumps(row), flush=True)
        return row["holds"]

    lo, hi, rate = None, None, args.start
    while hi is None and rate <= 256:
        if probe(rate):
            lo, rate = rate, rate * 2
        else:
            hi = rate
    for _ in range(args.bisect if lo is not None and hi is not None else 0):
        mid = (lo + hi) / 2
        if probe(mid):
            lo = mid
        else:
            hi = mid
    knee = lo
    cell_rate = (math.floor(0.8 * knee / 0.5) * 0.5) if knee else None
    print(json.dumps({"workload": cell.name, "knee_rps": knee,
                      "first_failing_rps": hi, "cell_rate_rps": cell_rate}),
          flush=True)
    run.engine.close(timeout=10.0)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
