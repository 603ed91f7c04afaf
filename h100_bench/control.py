"""The control and the lower readings of a cell's check, on the card.

    python3 h100_bench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

For each seed, one run of the cell at its own size and load (a short
window is enough: every request due in it is finished and compared, as
in a benchmark run), then the numbers the check compares, read twice:
from the program, which sets the lower reading, and from the control,
the plain reference computed in TF32 in the program's place, which has
to come out as not correct and sets the upper reading.  A training cell
also reads the fault of a step that leaves half of its batch out (the
reference on the first half of every batch).  One JSON line a seed on
standard output; the benchmark's own runs never run this.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench.bench import common  # noqa: E402


def readings(cell, seed: int, seconds: float, device="cuda") -> dict:
    run = cell.runner_module().Run(cell, seed, seconds, False,
                                   device=device)
    run.setup()
    run.window_run()
    run.free()
    run.verify(control=True)
    return {"seed": seed, "correct": run.correct,
            "program": {k: v["value"] for k, v in run.check.items()},
            "control": run.control,
            "reference_s": run.reference_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = common.Cell(common.load_benchmark(ROOT), args.workload, ROOT)
    common.require_cuda(cell.chips)
    print(f"[device] {common.nvidia_smi()}", flush=True)
    for seed in args.seeds:
        print(json.dumps({"workload": cell.name,
                          **readings(cell, seed, args.seconds)}),
              flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
