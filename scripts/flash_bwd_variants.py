#!/usr/bin/env python3
"""Time variants of the flash backward source side by side on one GPU.

    python3 scripts/flash_bwd_variants.py A.cu B.cu ...

Each argument is a copy of ``bigdl_tpu_torch/csrc/flash_bwd.cu`` with
some change.  All are built at once with the port's nvcc flags and
``-I bigdl_tpu_torch/csrc`` for the shared headers (ptxas register and
spill lines printed), then each library's dK/dV and dQ
kernels run on the same inputs, causal, zero lse cotangent: (8,12,1024,64)
in float32 and bf16 and (2,12,512,128) in float32.  For each variant it
prints every gradient's max abs error over its max |value| against the
plain backward, whether the outputs are bitwise equal to the first
variant's, and each kernel's device ms (CUDA events, two readings).
Variants are timed in turn in one process, so compare them only within
one run.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

SHAPES = [(8, 1024, 64, "float32"), (8, 1024, 64, "bfloat16"),
          (2, 512, 128, "float32")]


def build(sources):
    from bigdl_tpu_torch.ops._build import CSRC_DIR, NVCC_FLAGS, nvcc_path
    # the copies live outside csrc/: its shared headers come by -I
    procs = {s: subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-I",
                                  str(CSRC_DIR), "-o", s[:-3] + ".so", s],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for s in sources}
    libs = {}
    for s, p in procs.items():
        out = p.communicate()[0]
        print(f"== {s}: nvcc exit {p.returncode}")
        if p.returncode != 0:
            print(out[-3000:])
            continue
        for line in out.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill")):
                print("  ", line.strip()[-120:])
        libs[s] = ctypes.CDLL(os.path.abspath(s[:-3] + ".so"))
    return libs


def main() -> int:
    import torch
    import chip_smoke
    from bigdl_tpu_torch.ops import (flash_attention_backward_reference,
                                     flash_attention_reference)
    from bigdl_tpu_torch.ops.flash_attention import (FLASH_BWD_DKV,
                                                     FLASH_BWD_DQ,
                                                     BackwardInputs)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    libs = build(sys.argv[1:])
    entries = {}
    for s, lib in libs.items():
        fns = []
        for kernel in (FLASH_BWD_DKV, FLASH_BWD_DQ):
            fn = getattr(lib, kernel.symbol)
            fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
            fns.append(fn)
        entries[s] = fns
    dev = torch.device("cuda")
    for b, t, d, dtype in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        tdt = getattr(torch, dtype)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev).to(tdt)

        q, k, v = randn(b, 12, t, d), randn(b, 12, t, d), randn(b, 12, t, d)
        o, lse = flash_attention_reference(q, k, v, causal=True)
        do, dlse, scale = randn(*o.shape), torch.zeros_like(lse), d ** -0.5
        want = flash_attention_backward_reference(q, k, v, o, lse, do, dlse,
                                                  causal=True, scale=scale)
        x = BackwardInputs(q, k, v, o, lse, do, dlse, None, None, True,
                           scale)
        stream = torch.cuda.current_stream().cuda_stream
        first = None
        for s, (dkv, dq_fn) in entries.items():
            dk, dv, dq = (torch.empty_like(a) for a in (k, v, q))

            def run_dkv():
                assert dkv(*x.ptrs, dk.data_ptr(), dv.data_ptr(), *x.tail,
                           stream) == 0

            def run_dq():
                assert dq_fn(*x.ptrs, dq.data_ptr(), *x.tail, stream) == 0

            run_dkv()
            run_dq()
            torch.cuda.synchronize()
            got = (dq, dk, dv)
            errs = [((a.float() - w.float()).abs().max()
                     / w.float().abs().max()).item()
                    for a, w in zip(got, want)]
            same = (None if first is None
                    else all(torch.equal(a, c) for a, c in zip(got, first)))
            first = first or tuple(a.clone() for a in got)
            ms = [(chip_smoke.cuda_ms(run_dkv), chip_smoke.cuda_ms(run_dq))
                  for _ in range(2)]
            print(f"({b},12,{t},{d}) {dtype} {os.path.basename(s)}: errors "
                  f"dq/dk/dv {['%.2e' % e for e in errs]}, bitwise equal to "
                  f"the first: {same} | dk/dv ms "
                  f"{[round(a, 4) for a, _ in ms]}, dq ms "
                  f"{[round(c, 4) for _, c in ms]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
