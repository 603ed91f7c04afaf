#!/usr/bin/env python3
"""Time the paged decode kernel at several chunk sizes on one GPU.

    python3 scripts/paged_chunk_sweep.py [KEYS ...]     (default: 64 128)

Each size is the number of keys one thread block of
``bigdl_tpu_torch/csrc/paged_decode.cu`` attends (rounded down to whole
KV blocks of 16).  For each it sets
``bigdl_tpu_torch.ops.paged_attention.CHUNK_KEYS`` and runs chip_smoke's
paged case at the served slots' last decode step (S=8, H=12, D=64, 12
layers of the serve engine's arenas) in float32 and bf16: checked
against the plain version, bitwise repeatable, timed by CUDA events,
with the live K/V bytes and the TB/s they make.  The sizes are timed in
turn, twice, in one process: compare them only within one run.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from bigdl_tpu_torch.ops import paged_attention
    sizes = [int(a) for a in argv] or [64, 128]
    served = [t + chip_smoke.SERVE["max_new"] - 2
              for t in chip_smoke.SERVE["prompt_lens"]]
    dev = torch.device("cuda")
    print(chip_smoke.nvidia_smi_line(), flush=True)
    for turn in range(2):
        for keys in sizes:
            paged_attention.CHUNK_KEYS = keys
            for dtype in ("float32", "bfloat16"):
                r = chip_smoke.paged_case(dev, served, dtype)
                print(f"chunk {keys} keys, turn {turn}, {dtype}: kernel "
                      f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
