"""Input-pipeline-fed ResNet-50 bench (port of
``bigdl_tpu/models/utils/pipeline_bench.py``; ref
dataset/DataSet.scala:380-433 SequenceFile ImageNet path +
MTLabeledBGRImgToBatch.scala:52-80 threaded host decode): can the host
feed the card?

    python -m bigdl_tpu_torch.models.utils.pipeline_bench --batch 256 --iters 20
    python -m bigdl_tpu_torch.models.utils.pipeline_bench --host-only

Trains the same step twice: (a) on device-resident synthetic data, (b)
fed by the real path: record shards on disk -> native crop/flip/pack ->
bounded ``Prefetcher`` -> the copy to the card from pageable memory.
Prints one JSON line with both rates and their ratio, the copy of one
batch, the peak of allocated device memory and the card's name and
power limit.

The host stays in uint8 HWC end to end (shard read, random 224x224 crop
and horizontal flip are byte slicing); the card normalizes and casts to
bf16 inside the step.  The step: ResNet-50 at ImageNet width, NHWC,
``build(seed=1)``; SGD(0.1, momentum 0.9, dampening 0); float32 master
weights cast to bf16 for the forward; the loss in float32; float32
gradients into the update.

``--host-only`` measures the delivery rate with no device step; its
headroom is taken against a card rate the caller passes
(``--card-rate``, or ``run_host_only(card_rate=)``), else it is null.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

CROP = 224
STORED = 256
# ImageNet BGR mean/std in the reference's 0..255 scale
MEAN = (104.0, 117.0, 123.0)
STD = (1.0, 1.0, 1.0)


def generate_shards(workdir: str, n_records: int, n_shards: int = 8,
                    seed: int = 0) -> list[str]:
    """Synthetic stored-format dataset: STOREDxSTOREDx3 uint8 BGR images
    in the record-shard format, labels ``i % 1000 + 1`` (the role
    ImageNetSeqFileGenerator plays for the reference)."""
    from bigdl_tpu_torch.dataset.seqfile import write_sharded
    from bigdl_tpu_torch.dataset.types import ByteRecord

    rng = np.random.RandomState(seed)
    records = []
    for i in range(n_records):
        img = rng.randint(0, 256, size=(STORED, STORED, 3), dtype=np.uint8)
        records.append(ByteRecord(img.tobytes(), float(i % 1000 + 1)))
    return write_sharded(os.path.join(workdir, "imagenet"), records, n_shards)


def batch_stream(paths: list[str], batch: int, seed: int = 1,
                 n_threads: int = None, depth: int = 8):
    """shards -> crop/flip/pack -> (uint8 NHWC batch, float32 labels),
    prefetched; infinite epochs over a reshuffled shard order.

    The crop/flip/pack loop runs in the host library's batcher
    (``bt_crop_flip_pack``: a persistent thread pool and memcpy); under
    ``BIGDL_TPU_NO_NATIVE=1`` a Python thread pool slices the same
    windows.  The crop origins and flips come from
    ``np.random.RandomState(seed)``, so both paths, and the JAX
    package's, give the same batches."""
    from concurrent.futures import ThreadPoolExecutor

    from bigdl_tpu_torch import native
    from bigdl_tpu_torch.dataset.seqfile import read_shard
    from bigdl_tpu_torch.dataset.transformer import Prefetcher

    if n_threads is None:
        n_threads = max(4, (os.cpu_count() or 8) // 2)
    rng = np.random.RandomState(seed)
    lib = native.get()
    stored, crop = STORED, CROP

    def decode_one(args):
        data, label, cy, cx, flip = args
        img = np.frombuffer(data, np.uint8).reshape(stored, stored, 3)
        img = img[cy:cy + crop, cx:cx + crop]
        if flip:
            img = img[:, ::-1]
        return img, label

    def emit(buf_args, pool):
        y = np.asarray([a[1] for a in buf_args], np.float32)
        if lib is not None:
            x = lib.crop_flip_pack(
                [a[0] for a in buf_args], stored, stored, crop,
                [a[2] for a in buf_args], [a[3] for a in buf_args],
                [a[4] for a in buf_args], n_threads)
            return x, y
        out = list(pool.map(decode_one, buf_args, chunksize=8))
        return np.stack([o[0] for o in out]), y

    def raw_batches():
        pool = (None if lib is not None else
                ThreadPoolExecutor(max_workers=n_threads,
                                   thread_name_prefix="decode"))
        try:
            while True:
                order = rng.permutation(len(paths))
                buf_args = []
                for si in order:
                    for rec in read_shard(paths[si]):
                        span = stored - crop
                        buf_args.append((rec.data, rec.label,
                                         rng.randint(0, span + 1),
                                         rng.randint(0, span + 1),
                                         bool(rng.randint(2))))
                        if len(buf_args) == batch:
                            yield emit(buf_args, pool)
                            buf_args = []
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

    return Prefetcher(depth)(raw_batches())


def device_normalize(x_u8, mean, std):
    """The step's normalize on the device: ``(x - mean) / std`` in the
    dtype of ``mean`` and ``std`` (tensors of MEAN and STD made once:
    making them in the step would copy them to the card every step, a
    copy that waits for the stream) from the uint8 NHWC batch."""
    return (x_u8.to(mean.dtype) - mean) / std


def _train_pieces(batch: int, device=None):
    """(step, params, buffers, opt_state) of the bench's training step
    on ``device``; ``step(params, buffers, opt_state, x_u8, y, rng)``
    returns ``(params, buffers, opt_state, loss)``, the parameters and
    the SGD state updated in place, ``loss`` a detached float32 0-d
    tensor on the device.  ``batch`` is the caller's; the step takes
    any."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.device import resolve_device
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.nn._util import cast_f32_leaves
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.utils.pytree import tree_leaves, tree_map

    dev = resolve_device(device)
    model = ResNet(class_num=1000, depth=50, dataset="imagenet",
                   data_format="NHWC").build(seed=1, device=dev)
    criterion = nn.ClassNLLCriterion()
    method = SGD(learning_rate=0.1, momentum=0.9, dampening=0.0)
    params, buffers = model.params, model.buffers
    opt_state = method.init_state(params)
    mean = torch.tensor(MEAN, dtype=torch.bfloat16, device=dev)
    std = torch.tensor(STD, dtype=torch.bfloat16, device=dev)

    def step(params, buffers, opt_state, x_u8, y, rng):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            p16 = cast_f32_leaves(live, torch.bfloat16)
            x = device_normalize(x_u8, mean, std)
            out, nb = model.apply(p16, x, buffers=buffers, training=True,
                                  rng=rng)
            loss = criterion.loss(out.float(), y)
            flat = torch.autograd.grad(loss, leaves)
        it = iter(g.float() for g in flat)
        grads = tree_map(lambda _: next(it), params)
        params, opt_state = method.update(grads, opt_state, params)
        nb = tree_map(lambda b: b.detach(), nb)
        return params, nb, opt_state, loss.detach()

    return step, params, buffers, opt_state


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(batch: int, iters: int, warmup: int, workdir: str,
        n_records: int, device=None) -> dict:
    """The step's rate on device-resident data, then fed by the record
    path; see the module docstring."""
    import torch

    from bigdl_tpu_torch import native
    from bigdl_tpu_torch.device import resolve_device
    from bigdl_tpu_torch.models.utils.perf import device_stamp, input_copy_ms
    from bigdl_tpu_torch.utils import keychain

    dev = resolve_device(device)
    rng = keychain.prng_key(0)
    step, params, buffers, opt_state = _train_pieces(batch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # -- synthetic, device-resident ------------------------------------- #
    x_syn = torch.as_tensor(
        np.random.RandomState(0).randint(0, 256, size=(batch, CROP, CROP, 3),
                                         dtype=np.uint8), device=dev)
    y_syn = torch.as_tensor(
        np.random.RandomState(1).randint(1, 1001, size=batch)
        .astype(np.float32), device=dev)
    for _ in range(warmup):
        params, buffers, opt_state, loss = step(params, buffers, opt_state,
                                                x_syn, y_syn, rng)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        params, buffers, opt_state, loss = step(params, buffers, opt_state,
                                                x_syn, y_syn, rng)
    syn_loss = float(loss)
    dt_syn = time.perf_counter() - t0
    syn_ips = batch * iters / dt_syn

    # -- pipeline-fed ---------------------------------------------------- #
    paths = generate_shards(workdir, n_records)
    stream = batch_stream(paths, batch)
    try:
        for _ in range(warmup):
            x, y = next(stream)
            params, buffers, opt_state, loss = step(
                params, buffers, opt_state, torch.as_tensor(x, device=dev),
                torch.as_tensor(y, device=dev), rng)
        _sync(dev)
        wait_s = copy_s = 0.0
        t0 = time.perf_counter()
        for _ in range(iters):
            t1 = time.perf_counter()
            x, y = next(stream)
            t2 = time.perf_counter()
            xd = torch.as_tensor(x, device=dev)
            yd = torch.as_tensor(y, device=dev)
            t3 = time.perf_counter()
            wait_s, copy_s = wait_s + t2 - t1, copy_s + t3 - t2
            params, buffers, opt_state, loss = step(
                params, buffers, opt_state, xd, yd, rng)
        pipe_loss = float(loss)
        dt_pipe = time.perf_counter() - t0
    finally:
        stream.close()
    pipe_ips = batch * iters / dt_pipe
    return {
        "metric": "resnet50_pipeline_fed_vs_synthetic",
        "batch": batch, "iterations": iters,
        "synthetic_img_s": syn_ips,
        "pipeline_img_s": pipe_ips,
        "ratio": pipe_ips / syn_ips,
        "stored_records": n_records,
        "unit": "images/sec (one device)",
        "synthetic_step_ms": dt_syn / iters * 1e3,
        "pipeline_step_ms": dt_pipe / iters * 1e3,
        # host clock inside the fed loop: blocked on the Prefetcher, and
        # in the copy call (which waits for the stream to reach it)
        "pipeline_wait_ms": wait_s / iters * 1e3,
        "pipeline_copy_call_ms": copy_s / iters * 1e3,
        "last_loss": {"synthetic": syn_loss, "pipeline": pipe_loss},
        "input_copy_ms": input_copy_ms(x, dev),
        "input_bytes": int(x.nbytes),
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
        "native_batcher": native.get() is not None,
        **device_stamp(dev),
    }


def run_host_only(batch: int, iters: int, warmup: int, workdir: str,
                  n_records: int, card_rate: float = None) -> dict:
    """The host's delivery rate: shards -> crop/flip/pack -> Prefetcher,
    no device step.  ``headroom_vs_card_rate`` is that rate over
    ``card_rate`` (images/s a card consumes, measured by the caller),
    null without one.  Each batch is touched by a strided sum (every
    32nd row and column), enough to make a lazy reader produce it
    without charging a full reduction to the rate."""
    from bigdl_tpu_torch import native

    paths = generate_shards(workdir, n_records)
    stream = batch_stream(paths, batch)
    sink = 0
    try:
        for _ in range(warmup):
            x, y = next(stream)
            sink += int(x[:, ::32, ::32].sum()) + int(y.sum())
        t0 = time.perf_counter()
        for _ in range(iters):
            x, y = next(stream)
            sink += int(x[:, ::32, ::32].sum()) + int(y.sum())
        dt = time.perf_counter() - t0
    finally:
        stream.close()
    ips = batch * iters / dt
    return {
        "metric": "input_pipeline_host_delivery_images_per_sec",
        "value": ips,
        "unit": "images/sec (host only, no device step)",
        "batch": batch, "iterations": iters, "stored_records": n_records,
        "native_batcher": native.get() is not None,
        "card_rate": card_rate,
        "headroom_vs_card_rate": (None if card_rate is None
                                  else ips / card_rate),
        "checksum": sink % 1000,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--records", type=int, default=2048)
    p.add_argument("--host-only", action="store_true",
                   help="measure only the host delivery rate (no device "
                        "step)")
    p.add_argument("--card-rate", type=float, default=None,
                   help="images/s a card consumes, for --host-only's "
                        "headroom")
    p.add_argument("--workdir", default=None,
                   help="shard directory (default: fresh temp dir, removed "
                        "afterwards)")
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="pipeline_bench_")
    try:
        if args.host_only:
            result = run_host_only(args.batch, args.iters, args.warmup,
                                   workdir, args.records, args.card_rate)
        else:
            result = run(args.batch, args.iters, args.warmup, workdir,
                         args.records, device=args.device)
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(result))
    if args.json:
        from bigdl_tpu_torch.utils import fs
        fs.atomic_write(args.json, (json.dumps(result, indent=2) + "\n")
                        .encode())
    return result


if __name__ == "__main__":
    main()
