"""Per-layer cost attribution and the collective footprint (port of
``bigdl_tpu/utils/profiling.py``).

The reference accumulates per-module wall time in ``forward``/
``backward`` (nn/abstractnn/AbstractModule.scala:125-135).  The JAX
package reads each layer's cost out of XLA's cost analysis of the
compiled layer; the port counts it itself:

 1. a recording pass runs the model forward once and captures every
    container child's input (``Module._probe``);
 2. each leaf layer runs alone, forward and (for a training step) the
    gradient of the sum of its outputs with respect to its parameters,
    under ``torch.utils.flop_counter.FlopCounterMode``, which counts
    the products and convolutions (2 FLOPs a multiply-add; elementwise
    work, norms and pooling count 0).  Its bytes are its operands and
    results: parameters, buffers, input and output once each forward;
    the backward adds the output's gradient, the input again and the
    parameters' gradients;
 3. ``attribute_step_time`` splits a measured step over the layers by
    their roofline weight, ``max(flops / PEAK_FLOPS, bytes /
    PEAK_HBM_BYTES_S)``, and writes it into ``forward_time`` /
    ``backward_time``, so ``get_times()`` reports it;
 4. ``measure_layer_times`` times each leaf layer alone, with CUDA
    events on the card.

The planning constants are an NVIDIA H100 SXM5's: 67 TFLOP/s of float32
on the CUDA cores (the port trains in float32 with TF32 off), 3.35 TB/s
of HBM3, and 450 GB/s per direction of NVLink 4 (18 links of 25 GB/s).
``BIGDL_TPU_TORCH_PEAK_TFLOPS``, ``BIGDL_TPU_TORCH_HBM_GBPS`` and
``BIGDL_TPU_TORCH_LINK_GBPS`` override them, read once at import.

``collective_footprint`` sums the bytes each collective family produced
in one step, from the record the step's collectives keep
(``parallel.parameters.CollectiveRecord``): the reference reads the
same rows out of the compiled HLO, whose text parsers have no
counterpart here.
"""
from __future__ import annotations

import os
import time
import warnings
from typing import Iterable

import torch
from torch.utils.flop_counter import FlopCounterMode

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils import keychain
from bigdl_tpu_torch.utils.pytree import tree_leaves, tree_map

#: where each planning constant's value came from at import: "env",
#: "default" or "env-malformed-default" (read this, never os.environ at
#: call time: the environment may change after import)
_ENV_SOURCES: dict = {}


def _env_float(name: str, default: float) -> float:
    """An env override with a loud but survivable parse: a malformed
    value warns and keeps the default."""
    raw = os.environ.get(name)
    if raw is None:
        _ENV_SOURCES[name] = "default"
        return default
    try:
        value = float(raw)
    except ValueError:
        warnings.warn(f"{name}={raw!r} is not a number; using the default "
                      f"{default}")
        _ENV_SOURCES[name] = "env-malformed-default"
        return default
    _ENV_SOURCES[name] = "env"
    return value


def env_source(name: str) -> str:
    """Provenance of a planning constant as read at import: "env",
    "default" or "env-malformed-default"."""
    return _ENV_SOURCES.get(name, "default")


#: NVIDIA H100 SXM5: float32 on the CUDA cores, HBM3
PEAK_FLOPS = _env_float("BIGDL_TPU_TORCH_PEAK_TFLOPS", 67.0) * 1e12
PEAK_HBM_BYTES_S = _env_float("BIGDL_TPU_TORCH_HBM_GBPS", 3350.0) * 1e9
#: NVIDIA H100 SXM5: NVLink 4, 18 links x 25 GB/s per direction
LINK_GBPS_DEFAULT = _env_float("BIGDL_TPU_TORCH_LINK_GBPS", 450.0)


def _model_device(model: Module) -> torch.device:
    leaves = tree_leaves(model.params)
    return leaves[0].device if leaves else torch.device("cpu")


def _as_input(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(x, device=device)


def record_layer_inputs(model: Module, x, training: bool = False,
                        rng=None) -> list:
    """Run one forward (no gradients), returning [(parent, index,
    child, input, child_params, child_buffers)] for every child a
    container dispatches."""
    model._built()
    records = []

    def probe(parent, idx, child, inp, p, b):
        records.append((parent, idx, child, inp, p, b))

    Module._probe = probe
    try:
        with torch.no_grad():
            model.apply(model.params, _as_input(x, _model_device(model)),
                        buffers=model.buffers, training=training,
                        rng=rng if rng is not None else keychain.prng_key(0))
    finally:
        Module._probe = None
    return records


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _float_leaves(params) -> list:
    return [p for p in tree_leaves(params)
            if isinstance(p, torch.Tensor) and p.is_floating_point()]


def _forward(child: Module, params, buffers, inp, training: bool):
    y, _ = child.apply(params, inp, buffers=buffers, training=training,
                       rng=keychain.prng_key(0))
    return y


def _train(child: Module, params, buffers, inp, training: bool):
    """The forward and the gradient of the sum of its outputs with
    respect to the float parameters; the outputs when there are none."""
    leaves = _float_leaves(params)
    if not leaves:
        return _forward(child, params, buffers, inp, training)
    live = {id(p): p.detach().requires_grad_(True) for p in leaves}
    p_live = tree_map(lambda p: live.get(id(p), p), params)
    with torch.enable_grad():
        y = _forward(child, p_live, buffers, inp, training)
        total = sum(o.float().sum() for o in tree_leaves(y)
                    if isinstance(o, torch.Tensor))
        return torch.autograd.grad(total, list(live.values()),
                                   allow_unused=True)


def _layer_cost(child: Module, params, buffers, inp, training: bool,
                include_train: bool = True):
    """(fwd flops, train flops, fwd bytes, train bytes) of one layer."""
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        y = _forward(child, params, buffers, inp, training)
    f_fwd = float(counter.get_total_flops())
    p_bytes, in_bytes, out_bytes = _nbytes(params), _nbytes(inp), _nbytes(y)
    b_fwd = float(p_bytes + _nbytes(buffers) + in_bytes + out_bytes)
    if not include_train or not _float_leaves(params):
        return f_fwd, f_fwd, b_fwd, b_fwd
    counter = FlopCounterMode(display=False)
    with counter:
        _train(child, params, buffers, inp, training)
    f_train = float(counter.get_total_flops())
    # the backward reads the output's gradient and the input again and
    # writes the parameters' gradients
    b_train = b_fwd + out_bytes + in_bytes + p_bytes
    return f_fwd, f_train, b_fwd, b_train


def profile_layers(model: Module, x, training: bool = True,
                   include_train: bool = True) -> list:
    """Per-LEAF-layer FLOPs and bytes for one forward and one training
    step: [{'module', 'name', 'flops_fwd', 'flops_train', 'bytes_fwd',
    'bytes_train'}] in execution order.  ``include_train=False`` skips
    the backward (the train columns then mirror the forward's)."""
    rows = []
    for parent, idx, child, inp, p, b in record_layer_inputs(
            model, x, training=training):
        if getattr(child, "modules", None):
            continue  # containers: attributed through their leaves
        try:
            f_fwd, f_train, b_fwd, b_train = _layer_cost(
                child, p, b, inp, training, include_train=include_train)
        except Exception:
            f_fwd = f_train = b_fwd = b_train = 0.0
        rows.append({"module": child, "name": child.get_name(),
                     "flops_fwd": f_fwd, "flops_train": f_train,
                     "bytes_fwd": b_fwd, "bytes_train": b_train})
    return rows


def attribute_step_time(model: Module, x, step_time_s: float,
                        training: bool = True,
                        mode: str = "roofline") -> list:
    """Distribute a measured step's wall time over the leaf layers and
    add each layer's share to its ``forward_time``/``backward_time``.

    ``mode="roofline"`` (default) weighs a layer by max(flops /
    PEAK_FLOPS, bytes / PEAK_HBM_BYTES_S): a memory-bound BatchNorm is
    billed for its traffic, not its zero counted FLOPs; ``mode="flops"``
    splits by FLOPs alone.  Roofline rows carry ``bound`` ("compute" or
    "memory")."""
    if mode not in ("roofline", "flops"):
        raise ValueError(f"mode must be 'roofline'|'flops', got {mode!r}")
    rows = profile_layers(model, x, training=training)

    def weight(flops, bytes_):
        if mode == "flops":
            return flops
        return max(flops / PEAK_FLOPS, bytes_ / PEAK_HBM_BYTES_S)

    total = sum(weight(r["flops_train"], r["bytes_train"])
                for r in rows) or 1.0
    for r in rows:
        w = weight(r["flops_train"], r["bytes_train"])
        t = (w / total) * step_time_s
        if mode == "roofline":
            r["bound"] = ("compute" if r["flops_train"] / PEAK_FLOPS
                          >= r["bytes_train"] / PEAK_HBM_BYTES_S
                          else "memory")
        # the forward's share of the layer from its own forward weight
        w_fwd = weight(r["flops_fwd"], r["bytes_fwd"])
        fwd_frac = min(w_fwd / w, 1.0) if w > 0 else 1.0
        r["time_s"] = t
        r["attribution"] = mode
        r["module"].forward_time += t * fwd_frac
        r["module"].backward_time += t * (1.0 - fwd_frac)
    return rows


def _timed(fn, device: torch.device, iters: int, warmup: int):
    """Seconds a call of ``fn`` takes: CUDA events on the card, the host
    clock on the CPU; None if ``fn`` raises."""
    try:
        for _ in range(warmup):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    except Exception:
        return None


def measure_layer_times(model: Module, x, training: bool = True,
                        iters: int = 10, warmup: int = 2) -> list:
    """Measured time per leaf layer, each run alone on its recorded
    input: the forward, and (``training``) the forward with the
    gradient of its outputs' sum with respect to its parameters.  Rows
    say ``"granularity": "standalone"``: a layer alone pays launches a
    whole step shares, so use these to rank layers, and
    :func:`attribute_step_time` for shares that add up to a measured
    step.  Times are added to ``forward_time``/``backward_time``."""
    device = _model_device(model)
    rows = []
    for parent, idx, child, inp, p, b in record_layer_inputs(
            model, x, training=training):
        if getattr(child, "modules", None):
            continue

        def fwd(child=child, p=p, b=b, inp=inp):
            with torch.no_grad():
                return _forward(child, p, b, inp, training)

        def train(child=child, p=p, b=b, inp=inp):
            return _train(child, p, b, inp, training)

        t_fwd = _timed(fwd, device, iters, warmup)
        t_train = _timed(train, device, iters, warmup) if training else t_fwd
        rows.append({"module": child, "name": child.get_name(),
                     "measured_fwd_s": t_fwd, "measured_train_s": t_train,
                     "granularity": "standalone"})
        if t_fwd is not None:
            child.forward_time += t_fwd
        if t_train is not None and t_fwd is not None:
            child.backward_time += max(t_train - t_fwd, 0.0)
    return rows


def wire_bytes(footprint: dict, n: int) -> float:
    """Bytes a ring implementation moves per device for the collectives
    of a :func:`collective_footprint` dict on an ``n``-rank axis.  The
    footprint records bytes produced (each collective's result); a ring
    moves:

      all-gather:          out x (N-1)/N
      reduce-scatter:      out x (N-1)
      all-reduce:          out x 2(N-1)/N   (reduce-scatter + all-gather)
      collective-permute:  out
      all-to-all:          out x (N-1)/N

    The ZeRO-1 cycle (a bf16 all-gather of the weights and a bf16
    reduce-scatter of the gradients) comes to 2(N-1)/N x the parameter
    bytes: the ring all-reduce's volume."""
    if n <= 1:
        return 0.0
    factors = {"all-gather": (n - 1) / n, "reduce-scatter": float(n - 1),
               "all-reduce": 2 * (n - 1) / n, "collective-permute": 1.0,
               "all-to-all": (n - 1) / n}
    return float(sum(b * factors.get(op, 1.0) for op, b in footprint.items()))


def predict_ici_efficiency(compute_s: float, wire_bytes_per_chip: float,
                           ici_gbps: float = LINK_GBPS_DEFAULT) -> dict:
    """Weak-scaling prediction as an interval: with no overlap the step
    is compute + comm (the floor), with full overlap max(compute, comm)
    (the ceiling).  ``predicted_efficiency`` is the floor's.
    ``ici_gbps`` is the per-device link rate (default: the H100's NVLink
    4, :data:`LINK_GBPS_DEFAULT`)."""
    comm_s = wire_bytes_per_chip / (ici_gbps * 1e9)
    step_serial = compute_s + comm_s
    step_overlap = max(compute_s, comm_s)
    eff_lo = compute_s / step_serial if step_serial else 1.0
    eff_hi = compute_s / step_overlap if step_overlap else 1.0
    return {"predicted_comm_s": comm_s, "predicted_step_s": step_serial,
            "predicted_step_s_full_overlap": step_overlap,
            "predicted_efficiency": eff_lo,
            "predicted_efficiency_interval": [eff_lo, eff_hi]}


def collective_footprint(records: Iterable) -> dict:
    """Bytes produced in one step by each collective family, from the
    ``(op, dtype, numel)`` rows a ``CollectiveRecord`` kept: the
    all-gather row is the reference's getWeights ("get weights
    average") traffic, the reduce-scatter and all-reduce rows its
    putGradients and aggregate ("aggregate gradient time")."""
    out = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0,
           "collective-permute": 0, "all-to-all": 0}
    for op, dtype, numel in records:
        out[op] = out.get(op, 0) + int(numel) * torch.empty(
            (), dtype=dtype).element_size()
    return {k: v for k, v in out.items() if v}
