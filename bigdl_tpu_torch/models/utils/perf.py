"""Synthetic-data training throughput of the image classifiers (port of
``bigdl_tpu/models/utils/perf.py``; ref models/utils/LocalOptimizerPerf.scala
and DistriOptimizerPerf.scala).

    python -m bigdl_tpu_torch.models.utils.perf -m resnet50 -b 32 -i 10
    python -m bigdl_tpu_torch.models.utils.perf -m lenet5 -b 32 -i 5 --device cpu
    python -m bigdl_tpu_torch.models.utils.perf -m resnet50 --distributed
    torchrun --nproc-per-node 4 -m bigdl_tpu_torch.models.utils.perf \
        -m resnet50 --mesh 1,2,4 -b 32 -i 5 --json scaling.json

Each run builds the model from seed 1, trains it with ``LocalOptimizer``
(SGD, ClassNLL) on two batches of seeded random (or constant) images for
``warmup`` + ``iteration`` steps and reports the steady-state records/s
from the loop's ``computing time``, which ends at the host's read of
the step's loss and so holds the device's work.  It also reports the
median step, the peak of allocated device memory, the time of one
batch's copy from pageable host memory to the device (the copy every
step makes), the step's matmul and convolution FLOPs counted by
``torch.utils.flop_counter`` over one more step, and the device's name
and power limit.  ``--distributed`` trains with ``DistriOptimizer``
over the process world (a world of one unless ``torchrun`` starts
more).  ``--mesh`` runs the weak-scaling sweep (``run_scaling_sweep``)
over data-parallel meshes of the given sizes, each at most the world's
rank count: one rank per card, so one card sweeps only a mesh of 1.
"""
from __future__ import annotations

import argparse
import json
import os
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

    dev = resolve_device(device)
    if distributed:
        from bigdl_tpu_torch.parallel.mesh import init_world
        dev = init_world(dev.type)
    ds = _make_dataset(model_name, batch_size, data_type, data_format)
    model = build_model(model_name, data_format).build(seed=1, device=dev)
    criterion = nn.ClassNLLCriterion()
    batch = next(ds.data(train=False))
    copy_ms = input_copy_ms(batch.data, dev)
    flops = step_flops(model, criterion,
                       torch.as_tensor(batch.data, device=dev),
                       torch.as_tensor(batch.labels, device=dev))
    if distributed:
        from bigdl_tpu_torch.parallel import DistriOptimizer
        opt = DistriOptimizer(model, ds, criterion)
    else:
        opt = LocalOptimizer(model, ds, criterion)
    opt.set_optim_method(SGD(learning_rate=0.01)) \
       .set_end_when(Trigger.max_iteration(warmup + iterations))
    times = _capture_step_times(opt)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    opt.optimize()
    steady = times[warmup:]
    mean_step = sum(steady) / len(steady)
    from bigdl_tpu_torch.utils.pytree import tree_leaves
    return {"model": model_name, "batch_size": batch_size,
            "iterations": iterations, "data_format": data_format,
            "distributed": distributed,
            "param_count": sum(int(p.numel())
                               for p in tree_leaves(model.params)),
            "collective_bytes": (opt.collective_footprint()
                                 if distributed else None),
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


def run_scaling_sweep(model_name: str, per_chip_batch: int, iterations: int,
                      mesh_sizes: list, data_type: str = "random",
                      warmup: int = 2, data_format: str = "NCHW",
                      device=None, ici_gbps: float = None,
                      assume_compute_s: float = None,
                      compute_source: str = None,
                      predict_sizes: list = ()) -> dict:
    """Weak-scaling sweep (ref DistriOptimizerPerf): a fixed batch a
    rank, the global batch growing with the mesh, ``DistriOptimizer``
    over ``data_parallel_mesh(n)`` for each size n.  measured_efficiency
    (N) = t_step(N0) / t_step(N).  Each row also carries the step's
    collective bytes (``collective_footprint``), the wire bytes a ring
    moves for them, and the predicted efficiency interval, compute /
    (compute + wire / link) to compute / max(compute, wire / link), the
    link the H100's NVLink unless ``ici_gbps`` says otherwise.
    ``predict_sizes`` extrapolates the prediction to unswept sizes.

    Every rank of the world calls it (the meshes are made collectively);
    ranks outside a smaller mesh wait.  A size larger than the world
    refuses, naming the card count: one rank drives one card."""
    import torch
    import torch.distributed as dist

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.device import resolve_device
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.parallel.mesh import (data_parallel_mesh, in_mesh,
                                               init_world)
    from bigdl_tpu_torch.utils import profiling

    # the world this sweep would run in: the one running, else torchrun's
    # (or one rank), checked before a world is started for nothing
    world = dist.get_world_size() if dist.is_initialized() \
        else int(os.environ.get("WORLD_SIZE", 1))
    if max(mesh_sizes) > world:
        raise SystemExit(
            f"--mesh {max(mesh_sizes)} needs {max(mesh_sizes)} ranks, one "
            f"per card; this world has {world} (CUDA devices visible: "
            f"{torch.cuda.device_count()}); start more with torchrun")
    dev = init_world(resolve_device(device).type)
    if ici_gbps is not None:
        ici_gbps_source = "--ici-gbps CLI value (caller-supplied)"
    elif profiling.env_source("BIGDL_TPU_TORCH_LINK_GBPS") == "env":
        ici_gbps_source = ("BIGDL_TPU_TORCH_LINK_GBPS env override (read "
                           "at profiling import)")
    else:
        ici_gbps_source = (
            "planning number: NVIDIA H100 SXM5 NVLink 4, 18 links x 25 "
            "GB/s per direction (utils/profiling.py:LINK_GBPS_DEFAULT); "
            "not measured")
    if ici_gbps is None:
        ici_gbps = profiling.LINK_GBPS_DEFAULT
    rows = []
    for n in sorted(mesh_sizes):
        mesh = data_parallel_mesh(n)
        ds = _make_dataset(model_name, per_chip_batch, data_type,
                           data_format)
        model = build_model(model_name, data_format).build(seed=1,
                                                           device=dev)
        opt = DistriOptimizer(model, ds, nn.ClassNLLCriterion(), mesh=mesh)
        opt.set_optim_method(SGD(learning_rate=0.01)) \
           .set_end_when(Trigger.max_iteration(warmup + iterations))
        times = _capture_step_times(opt)
        opt.optimize()
        if in_mesh(mesh):
            steady = times[warmup:]
            mean_step = sum(steady) / len(steady)
            fp = opt.collective_footprint()
            rows.append({"mesh": n, "global_batch": per_chip_batch * n,
                         "mean_step_s": mean_step,
                         "records_s": per_chip_batch * n / mean_step,
                         "records_s_per_chip": per_chip_batch / mean_step,
                         "collective_bytes_produced": fp,
                         "collective_wire_bytes_per_chip":
                             profiling.wire_bytes(fp, n)})
        dist.barrier()
    base = rows[0]["mean_step_s"]
    compute_s = assume_compute_s if assume_compute_s else base
    for r in rows:
        r["measured_efficiency"] = base / r["mean_step_s"]
        r["overhead_share"] = max(0.0, 1.0 - r["measured_efficiency"])
        r.update(profiling.predict_ici_efficiency(
            compute_s, r["collective_wire_bytes_per_chip"], ici_gbps))
    # unswept sizes: the all-gather bytes (the full parameters) and the
    # reduce-scatter's input bytes do not depend on N
    predicted = []
    fp = rows[-1]["collective_bytes_produced"]
    n_ref = rows[-1]["mesh"]
    ag = fp.get("all-gather", 0)
    rs_input = fp.get("reduce-scatter", 0) * n_ref
    other = {k: v for k, v in fp.items()
             if k not in ("all-gather", "reduce-scatter")}
    for n in predict_sizes:
        if n <= 1:
            continue
        scaled = dict(other)
        if ag:
            scaled["all-gather"] = ag
        if rs_input:
            scaled["reduce-scatter"] = rs_input // n
        wire = profiling.wire_bytes(scaled, n)
        row = {"mesh": n, "collective_wire_bytes_per_chip": wire}
        row.update(profiling.predict_ici_efficiency(compute_s, wire,
                                                    ici_gbps))
        predicted.append(row)
    out = {"model": model_name, "per_chip_batch": per_chip_batch,
           "data_format": data_format, "iterations": iterations,
           "ici_model": {
               "ici_gbps": ici_gbps, "ici_gbps_source": ici_gbps_source,
               "compute_s": compute_s,
               "compute_source": (compute_source
                                  if compute_source and assume_compute_s
                                  else "assumed (caller-supplied)"
                                  if assume_compute_s else
                                  f"measured at mesh={rows[0]['mesh']}"),
               "formula": "eff(N) = compute / (compute + wire_bytes(N)/link)",
           },
           "sweep": rows, **device_stamp(dev)}
    if predicted:
        out["predicted"] = predicted
    return out


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
                   help="comma-separated mesh sizes for the scaling sweep, "
                        "e.g. 1,2,4 (at most the world's ranks)")
    p.add_argument("--predict", default=None,
                   help="comma-separated mesh sizes to extrapolate the link "
                        "prediction to")
    p.add_argument("--ici-gbps", type=float, default=None,
                   help="per-device link rate for the prediction (default: "
                        "the H100's NVLink 4 planning number)")
    p.add_argument("--json", default=None,
                   help="write the result as JSON to this path")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if args.mesh:
        result = run_scaling_sweep(
            args.model, args.batchSize, args.iteration,
            [int(s) for s in args.mesh.split(",")],
            data_type=args.dataType, data_format=args.dataFormat,
            device=args.device, ici_gbps=args.ici_gbps,
            predict_sizes=([int(s) for s in args.predict.split(",")]
                           if args.predict else ()))
        for r in result["sweep"]:
            lo, hi = r["predicted_efficiency_interval"]
            print(f"mesh {r['mesh']:>3}: {r['mean_step_s'] * 1e3:8.1f} "
                  f"ms/step, {r['records_s']:9.1f} records/s, measured eff "
                  f"{r['measured_efficiency'] * 100:6.1f}%, predicted eff "
                  f"[{lo * 100:.1f}%, {hi * 100:.1f}%] "
                  f"({r['collective_wire_bytes_per_chip'] / 1e6:.1f} MB "
                  f"wire)")
    else:
        result = run_perf(args.model, args.batchSize, args.iteration,
                          distributed=args.distributed,
                          data_type=args.dataType,
                          data_format=args.dataFormat, device=args.device)
        print(f"{result['model']}: {result['throughput_rec_s']:.1f} "
              f"records/s ({result['mean_step_s'] * 1e3:.1f} ms/step mean, "
              f"{result['median_step_s'] * 1e3:.1f} median, batch "
              f"{result['batch_size']}, {result['data_format']}) on "
              f"{result['nvidia_smi'] or result['device_name']}")
    if args.json:
        from bigdl_tpu_torch.utils import fs
        fs.atomic_write(args.json, json.dumps(result, indent=2).encode())
    return result


if __name__ == "__main__":
    main()
