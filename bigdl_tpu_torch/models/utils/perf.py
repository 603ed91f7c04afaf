"""Synthetic-data training throughput of the image classifiers (port of
``bigdl_tpu/models/utils/perf.py``, local mode; ref
models/utils/LocalOptimizerPerf.scala).

    python -m bigdl_tpu_torch.models.utils.perf -m resnet50 -b 32 -i 10
    python -m bigdl_tpu_torch.models.utils.perf -m lenet5 -b 32 -i 5 --device cpu

Each run builds the model from seed 1, trains it with ``LocalOptimizer``
(SGD, ClassNLL) on two batches of seeded random (or constant) images for
``warmup`` + ``iteration`` steps and reports the steady-state records/s
from the loop's ``computing time``, which ends at the host's read of
the step's loss and so holds the device's work.  It also reports the
median step, the peak of allocated device memory, the time of one
batch's copy from pageable host memory to the device (the copy every
step makes), the step's matmul and convolution FLOPs counted by
``torch.utils.flop_counter`` over one more step, and the device's name
and power limit.  ``--distributed`` and ``--mesh`` are refused (ROADMAP
Queue 1 item 12: distributed training).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np

MODELS = {
    "lenet5": ("mnist", 28),
    "alexnet": ("imagenet", 227),
    "inception_v1": ("imagenet", 224),
    "inception_v2": ("imagenet", 224),
    "vgg16": ("imagenet", 224),
    "vgg19": ("imagenet", 224),
    "resnet50": ("imagenet", 224),
    "vgg_cifar": ("cifar", 32),
}


def build_model(name: str, data_format: str = "NCHW"):
    from bigdl_tpu_torch import models
    df = data_format
    if name in ("lenet5", "alexnet") and df != "NCHW":
        raise ValueError(f"{name} supports NCHW only")
    if name == "lenet5":
        return models.LeNet5(10)
    if name == "alexnet":
        return models.AlexNet(1000)
    if name == "inception_v1":
        return models.Inception_v1(1000, data_format=df)
    if name == "inception_v2":
        return models.Inception_v2(1000, data_format=df)
    if name == "vgg16":
        return models.Vgg_16(1000, data_format=df)
    if name == "vgg19":
        return models.Vgg_19(1000, data_format=df)
    if name == "resnet50":
        return models.ResNet(1000, depth=50, dataset="imagenet",
                             data_format=df)
    if name == "vgg_cifar":
        return models.VggForCifar10(10, data_format=df)
    raise ValueError(f"unknown model {name}; choose from {sorted(MODELS)}")


def _sample_shape(model_name: str, data_format: str):
    kind, size = MODELS[model_name]
    if model_name == "lenet5":
        return (1, 28, 28), 10
    n_classes = 10 if kind in ("mnist", "cifar") else 1000
    shape = ((size, size, 3) if data_format == "NHWC" else (3, size, size))
    return shape, n_classes


def _make_dataset(model_name: str, batch_size: int, data_type: str,
                  data_format: str):
    """Two batches of seeded images (``randn`` from RandomState(0), or
    ones) with 1-based labels ``i % classes + 1``."""
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch

    shape, n_classes = _sample_shape(model_name, data_format)
    rng = np.random.RandomState(0)

    def gen():
        if data_type == "constant":
            return np.ones(shape, np.float32)
        return rng.randn(*shape).astype(np.float32)

    samples = [Sample(gen(), np.asarray(float(i % n_classes) + 1,
                                        dtype=np.float32))
               for i in range(batch_size * 2)]
    return DataSet.array(samples) >> SampleToBatch(batch_size,
                                                   drop_last=True)


def _capture_step_times(opt) -> list:
    times: list = []
    orig_add = opt.metrics.add

    def capture(name, value):
        if name == "computing time":
            times.append(value)
        orig_add(name, value)
    opt.metrics.add = capture
    return times


def device_stamp(device) -> dict:
    """The platform, the device's name and, on a card, nvidia-smi's
    "name, power.limit" line."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "device_name": "cpu", "nvidia_smi": None}
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return {"platform": "gpu",
            "device_name": torch.cuda.get_device_name(device),
            "nvidia_smi": out.stdout.strip().splitlines()[device.index or 0]}


def input_copy_ms(batch: np.ndarray, device, repeats: int = 5) -> float:
    """Median ms of the loop's copy of one batch from pageable host
    memory to ``device`` (``torch.as_tensor(array, device=)``), each copy
    waited for."""
    import torch
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        torch.as_tensor(batch, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def step_flops(model, criterion, data, labels) -> int:
    """The matmul and convolution FLOPs of one training step (forward and
    backward, the gradients it computes), as ``torch.utils.flop_counter``
    counts them from the ops' shapes; batch norm, pooling and
    elementwise work are not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    from bigdl_tpu_torch.optim import loss_and_grads
    from bigdl_tpu_torch.utils import keychain
    counter = FlopCounterMode(display=False)
    with counter:
        loss_and_grads(model, criterion, model.params, data, labels,
                       buffers=model.buffers, rng=keychain.prng_key(0))
    return int(counter.get_total_flops())


def run_perf(model_name: str, batch_size: int, iterations: int,
             distributed: bool = False, data_type: str = "random",
             warmup: int = 3, dtype="float32", data_format: str = "NCHW",
             device=None) -> dict:
    """Train ``warmup + iterations`` steps on ``device`` (the card unless
    it names the CPU) and report the steady state (see the module
    docstring)."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.device import resolve_device
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    if distributed:
        raise NotImplementedError(
            "distributed perf runs are not ported yet (ROADMAP Queue 1 item "
            "12: distributed training)")
    dev = resolve_device(device)
    ds = _make_dataset(model_name, batch_size, data_type, data_format)
    model = build_model(model_name, data_format).build(seed=1, device=dev)
    criterion = nn.ClassNLLCriterion()
    batch = next(ds.data(train=False))
    copy_ms = input_copy_ms(batch.data, dev)
    flops = step_flops(model, criterion,
                       torch.as_tensor(batch.data, device=dev),
                       torch.as_tensor(batch.labels, device=dev))
    opt = LocalOptimizer(model, ds, criterion)
    opt.set_optim_method(SGD(learning_rate=0.01)) \
       .set_end_when(Trigger.max_iteration(warmup + iterations))
    times = _capture_step_times(opt)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    opt.optimize()
    steady = times[warmup:]
    mean_step = sum(steady) / len(steady)
    return {"model": model_name, "batch_size": batch_size,
            "iterations": iterations, "data_format": data_format,
            "throughput_rec_s": batch_size / mean_step,
            "mean_step_s": mean_step,
            "median_step_s": statistics.median(steady),
            "step_s": steady,
            "loss": opt.state["loss"],
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
            "input_copy_ms": copy_ms,
            "input_bytes": int(batch.data.nbytes),
            "step_flops": flops,
            **device_stamp(dev)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Synthetic throughput benchmark")
    p.add_argument("-m", "--model", default="inception_v1",
                   choices=sorted(MODELS))
    p.add_argument("-b", "--batchSize", type=int, default=32)
    p.add_argument("-i", "--iteration", type=int, default=20)
    p.add_argument("-t", "--dataType", default="random",
                   choices=["random", "constant"])
    p.add_argument("--dataFormat", default="NCHW", choices=["NCHW", "NHWC"],
                   help="activation layout")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--mesh", default=None,
                   help="scaling sweep over mesh sizes (not ported)")
    p.add_argument("--json", default=None,
                   help="write the result as JSON to this path")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if args.mesh or args.distributed:
        raise SystemExit("--distributed and --mesh (run_scaling_sweep) are "
                         "not ported yet (ROADMAP Queue 1 item 12: "
                         "distributed training)")
    result = run_perf(args.model, args.batchSize, args.iteration,
                      data_type=args.dataType, data_format=args.dataFormat,
                      device=args.device)
    print(f"{result['model']}: {result['throughput_rec_s']:.1f} records/s "
          f"({result['mean_step_s'] * 1e3:.1f} ms/step mean, "
          f"{result['median_step_s'] * 1e3:.1f} median, batch "
          f"{result['batch_size']}, {result['data_format']}) on "
          f"{result['nvidia_smi'] or result['device_name']}")
    if args.json:
        from bigdl_tpu_torch.utils import fs
        fs.atomic_write(args.json, json.dumps(result, indent=2).encode())
    return result


if __name__ == "__main__":
    main()
