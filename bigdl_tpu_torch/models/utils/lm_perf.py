"""TransformerLM training throughput (tokens/s) (port of
``bigdl_tpu/models/utils/lm_perf.py``).

    python -m bigdl_tpu_torch.models.utils.lm_perf -t 1024 -b 8 --flash
    python -m bigdl_tpu_torch.models.utils.lm_perf --sweep 512,1024 \
        --json lm_perf.json

Prints ONE JSON line: the steady-state time of a full train step
(forward, backward through autograd, the Adam or SGD update) at the
given shape, with float32 master weights and the products in
``--dtype`` (bf16 by default), and the platform stamp.  ``--flash``
runs the flash kernels, otherwise plain attention.  ``--sweep`` times
flash and plain at each length (batch scaled to keep the tokens a step)
into a resumable document at ``--json``; nothing is written unless
``--json`` names a file.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import time


def run_lm_perf(seq_len: int, batch: int, *, vocab: int = 32000,
                hidden: int = 512, heads: int = 8, layers: int = 4,
                flash: bool = False, remat: bool = False,
                optim: str = "adam", dtype: str = "bfloat16",
                iters: int = 10, warmup: int = 2, device=None) -> dict:
    import numpy as np
    import torch

    from bigdl_tpu_torch.device import resolve_device
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import SGD, Adam
    from bigdl_tpu_torch.optim.optimizer import loss_and_grads
    from bigdl_tpu_torch.utils.artifacts import platform_stamp

    dev = resolve_device(device)
    # the baseline arm pinned to plain attention: "auto" would pick the
    # kernels on the card, making the sweep flash against flash
    model = TransformerLM(
        vocab_size=vocab, hidden_size=hidden, n_head=heads, n_layers=layers,
        max_len=seq_len, remat=remat,
        attention_impl="flash" if flash else "xla", device=dev).build(seed=1)
    crit = TimeDistributedCriterion(ClassNLLCriterion(), True)
    method = (Adam(learning_rate=1e-3) if optim == "adam"
              else SGD(learning_rate=0.1))
    params = model.params
    state = method.init_state(params)
    compute = torch.bfloat16 if dtype == "bfloat16" else None
    rng = np.random.RandomState(0)
    x, y = (torch.tensor(rng.randint(1, vocab + 1, size=(batch, seq_len))
                         .astype(np.float32), device=dev) for _ in range(2))

    def step():
        loss, grads, _ = loss_and_grads(model, crit, params, x, y,
                                        compute_dtype=compute)
        method.update(grads, state, params)
        return loss

    loss = None
    for _ in range(warmup):
        loss = step()
    if loss is not None:
        float(loss)  # synchronises
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = step()
    float(loss)
    dt_s = (time.perf_counter() - t0) / iters
    return {"metric": "transformer_lm_train_step",
            "seq_len": seq_len, "batch": batch, "vocab": vocab,
            "hidden": hidden, "heads": heads, "layers": layers,
            "flash": flash, "remat": remat, "optim": optim, "dtype": dtype,
            "iters": iters, "step_s": round(dt_s, 5),
            "tokens_per_s": round(batch * seq_len / dt_s, 1),
            **platform_stamp(dev)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="TransformerLM train throughput")
    p.add_argument("-t", "--seqLen", type=int, default=1024)
    p.add_argument("--sweep", default=None,
                   help="comma-separated seq lens (each timed flash AND "
                        "plain attention); overrides --seqLen/--flash")
    p.add_argument("-b", "--batch", type=int, default=8)
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--flash", action="store_true",
                   help="the flash kernels as the attention core")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block in the backward")
    p.add_argument("--optim", default="adam", choices=["sgd", "adam"])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("-i", "--iteration", type=int, default=10)
    p.add_argument("--json", default=None,
                   help="write the sweep document to this path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from bigdl_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    kw = dict(vocab=args.vocab, hidden=args.hidden, heads=args.heads,
              layers=args.layers, remat=args.remat, optim=args.optim,
              dtype=args.dtype, iters=args.iteration, device=dev)
    if not args.sweep:
        print(json.dumps(run_lm_perf(args.seqLen, args.batch,
                                     flash=args.flash, **kw)))
        return

    plat = "gpu" if dev.type == "cuda" else "cpu"
    # resume: reuse the successful same-config rows of a killed sweep;
    # rows of another platform or iteration count never qualify
    from bigdl_tpu_torch.utils.artifacts import (load_resumable_rows,
                                                 platform_stamp,
                                                 write_artifact)
    prev = load_resumable_rows(
        args.json,
        match=lambda old, r: (
            old.get("platform") == plat and "tokens_per_s" in r
            and r.get("vocab") == args.vocab
            and r.get("hidden") == args.hidden
            and r.get("heads") == args.heads
            and r.get("layers") == args.layers
            and r.get("remat") == args.remat
            and r.get("optim") == args.optim
            and r.get("dtype") == args.dtype
            and r.get("iters") == args.iteration),
        key=lambda r: (r.get("seq_len"), r.get("flash"), r.get("batch")))
    rows = []
    result = {"platform": plat, "rows": rows, "complete": False}

    def flush():
        result.update(platform_stamp(dev))
        write_artifact(args.json, result)

    for t in (int(s) for s in args.sweep.split(",")):
        for flash in (True, False):
            # keep the tokens a step: long T at a fixed batch would run
            # the plain core out of memory first
            eff_batch = max(1, args.batch * args.seqLen // t)
            if (t, flash, eff_batch) in prev:
                row = dict(prev[(t, flash, eff_batch)],
                           reused_from_previous_run=True)
            else:
                row = {"seq_len": t, "flash": flash}
                try:
                    row = run_lm_perf(t, eff_batch, flash=flash, **kw)
                except Exception as e:  # noqa: BLE001 -- recorded
                    from bigdl_tpu_torch.ops.autotune import _is_sticky
                    if _is_sticky(e):
                        raise
                    row["error"] = f"{type(e).__name__}: {str(e)[:300]}"
            rows.append(row)
            flush()
            print(json.dumps(row), flush=True)
    result["complete"] = True
    flush()


if __name__ == "__main__":
    main()
