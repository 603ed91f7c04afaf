"""Long-context training example (port of
``bigdl_tpu/example/long_context_lm.py``: the same flags, plus
``--device``): one TransformerLM in three scaling regimes.

    # 1. one device, flash attention + remat (the memory-bound regime)
    python -m bigdl_tpu_torch.example.long_context_lm --seqLength 4096 \\
        --flash --remat

    # 2. sequence-parallel over N ranks, one a card (ring attention)
    torchrun --nproc_per_node 4 -m bigdl_tpu_torch.example.long_context_lm \\
        --seqLength 4096 --sp 4

    # 3. the same with Ulysses all-to-all instead of the ring
    torchrun --nproc_per_node 4 -m bigdl_tpu_torch.example.long_context_lm \\
        --seqLength 4096 --sp 4 --ulysses

Runs a few Adam steps on seeded synthetic token streams and prints the
per-step time, tokens/s and the loss, so the regimes compare on the same
hardware.  ``--sp N`` needs a world of N ranks: the one ``torchrun``
starts, or the caller's own (``parallel.init_world`` in each rank
before ``main``); ``--sp 1`` starts a world of one.  Unlike the
reference it makes no virtual devices.  The flash kernels take head
widths 64 and 128 only, so ``--flash`` at the default widths (256 over
8 heads: 32) raises on a card; GPT-2 small's (``--hiddenSize 768
--nHead 12``) run.
"""
from __future__ import annotations

import argparse
import logging
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Long-context LM training demo")
    p.add_argument("-t", "--seqLength", type=int, default=4096)
    p.add_argument("-b", "--batchSize", type=int, default=2)
    p.add_argument("--vocabSize", type=int, default=8192)
    p.add_argument("--hiddenSize", type=int, default=256)
    p.add_argument("--nHead", type=int, default=8)
    p.add_argument("--nLayers", type=int, default=4)
    p.add_argument("--flash", action="store_true",
                   help="the flash-attention kernels")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block in the backward")
    p.add_argument("--sp", type=int, default=0,
                   help="shard the sequence over this many ranks (a world "
                        "of that size: torchrun, one rank a device)")
    p.add_argument("--ulysses", action="store_true",
                   help="all-to-all sequence parallelism instead of ring")
    p.add_argument("-i", "--iteration", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def sequence_mesh(n: int, device: str):
    """A 1-D mesh on the sequence axis over a world of ``n`` ranks, and
    this rank's device.  Starts a world of one for ``n == 1``, or the
    world ``torchrun``'s environment names; raises for ``n > 1`` with no
    world to join."""
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel.mesh import (SEQUENCE_AXIS, create_mesh,
                                               init_world)
    if not dist.is_initialized() and n > 1 and "WORLD_SIZE" not in os.environ:
        raise ValueError(
            f"--sp {n} needs a world of {n} ranks, one a device, and none "
            f"is running: start it with `torchrun --nproc_per_node {n} -m "
            f"bigdl_tpu_torch.example.long_context_lm --sp {n} ...`, or "
            f"call bigdl_tpu_torch.parallel.init_world(device, "
            f"init_method=..., rank=r, world_size={n}) in each rank before "
            f"main()")
    dev = init_world(device)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"--sp {n} needs a world of {n} ranks; the "
                         f"running one has {world}")
    return create_mesh({SEQUENCE_AXIS: n}, device_type=dev.type), dev


def main(argv=None) -> dict:
    """Train; returns the run's numbers (mode, the first and last loss,
    ms a step, tokens/s and, on a card, the peak of allocated bytes)."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import numpy as np
    import torch
    import torch.distributed as dist

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.device import resolve_device
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.optim import Adam
    from bigdl_tpu_torch.utils.pytree import tree_flatten, tree_unflatten

    dev = resolve_device(args.device)
    mesh = None
    if args.sp:
        mesh, dev = sequence_mesh(args.sp, dev.type)
    model = TransformerLM(
        vocab_size=args.vocabSize, hidden_size=args.hiddenSize,
        n_head=args.nHead, n_layers=args.nLayers, max_len=args.seqLength,
        remat=args.remat,
        attention_impl="flash" if args.flash else "auto",
        device=dev).build(seed=1)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(), True)
    method = Adam(learning_rate=1e-3)
    params = model.params
    leaves, treedef = tree_flatten(params)
    for t in leaves:
        t.requires_grad_(True)
    opt_state = method.init_state(params)

    rng = np.random.RandomState(0)
    shape = (args.batchSize, args.seqLength)
    ids = torch.as_tensor(rng.randint(1, args.vocabSize + 1, size=shape)
                          .astype(np.float32), device=dev)
    labels = torch.as_tensor(rng.randint(1, args.vocabSize + 1, size=shape)
                             .astype(np.float32), device=dev)

    if args.sp:
        from bigdl_tpu_torch.models.transformer.sp import (ring_lm_apply,
                                                           ulysses_lm_apply)
        sp_apply = ulysses_lm_apply if args.ulysses else ring_lm_apply

        def forward(x):
            return sp_apply(model, params, x, mesh)
        mode = f"sp={args.sp} ({'ulysses' if args.ulysses else 'ring'})"
    else:
        def forward(x):
            return model.apply(params, x)[0]
        mode = "single-device"

    def step():
        loss = crit.loss(forward(ids), labels)
        grads = torch.autograd.grad(loss, leaves)
        method.update(tree_unflatten(treedef, list(grads)), opt_state,
                      params)
        return loss.detach()

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    first = float(step())  # warm-up and sync
    t0 = time.perf_counter()
    for _ in range(args.iteration):
        loss = step()
    final = float(loss)  # waits for the last step
    dt = (time.perf_counter() - t0) / args.iteration
    tokens = args.batchSize * args.seqLength
    out = {"mode": mode, "first_loss": first, "loss": final,
           "ms_per_step": dt * 1e3, "tokens_per_s": tokens / dt,
           "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else None)}
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"[{mode}] T={args.seqLength} flash={args.flash} "
              f"remat={args.remat}: {dt * 1000:.1f} ms/step, "
              f"{tokens / dt:,.0f} tokens/s, loss {final:.4f}")
    return out


if __name__ == "__main__":
    main()
