"""ServingEngine: a built ``nn.Module`` as a servable endpoint (port of
``bigdl_tpu/serving/engine.py``).

A frozen params/buffers tree shared by every request (BigDL's serving
model, arXiv 1804.05839: batched forward passes over a shared immutable
model), with

- ``apply`` with ``training=False`` (no buffer writes, no dropout) run
  through one :class:`~bigdl_tpu_torch.serving.compile_cache.CompileCache`
  entry per batch bucket: on the card a captured CUDA graph, on the CPU
  (or with ``cuda_graphs=False``) the eager function;
- a :class:`~bigdl_tpu_torch.serving.batcher.DynamicBatcher` gathering
  requests into bucket-padded batches (sync ``predict`` rides the same
  queue as async ``submit``: one dispatch path, one ordering);
- chunked host-to-device staging (``host_transfer.HostStager``) on the
  eager path, each slice crossing the ``transfer.chunk`` fault site as
  in the reference; a graph entry stages into its own pinned buffers and
  static inputs, so under graphs the stager only counts the bytes;
- ``metrics.ServingMetrics`` splitting latency into queue wait and
  device time, exportable through the visualization tfevents writers.

A graph's outputs live in its pool and are valid only until the next
replay, so each batch's output leaves are copied to the host before the
batcher slices them back.  The output may be one array or any nest of
arrays (multi-headed models, Tables); every leaf must carry the batch
dim first, which is checked.

Placement (``placement=``, a
:class:`~bigdl_tpu_torch.serving.placement.MeshSlice`): the params are
staged onto the slot by ``shard_params_chunked``, the buffers whole.  A
slot of one card serves as an unplaced engine on that card does.  A
``tp > 1`` slot holds DTensor params (``serving_tp_rules``: Megatron
col/row over the module's Linears); its forward meets the plain batch
as replicated, its outputs are made whole before the host pull, it runs
eagerly, and its batcher decides each round with the slot's other ranks
(``placement.lockstep``): every rank is handed the same requests, in
the same order, and runs the same batches.
"""
from __future__ import annotations

import contextlib
import weakref
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.obs import (env_watchdog_enabled, env_watchdog_kwargs,
                                 get_registry, get_tracer, shared_watchdog)
from bigdl_tpu_torch.parallel.tensor_parallel import (replicate_on,
                                                      sharded_step)
from bigdl_tpu_torch.quant.transform import (dequantize_entry,
                                             params_dtype_tag,
                                             params_nbytes,
                                             stage_quantized_params)
from bigdl_tpu_torch.serving.batcher import (DynamicBatcher, ServingClosed,
                                             power_of_two_buckets)
from bigdl_tpu_torch.serving.compile_cache import CompileCache, GraphPool
from bigdl_tpu_torch.serving.host_transfer import HostStager
from bigdl_tpu_torch.serving.metrics import ServingMetrics
from bigdl_tpu_torch.utils import keychain, pytree
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.transfer import DEFAULT_CHUNK_BYTES

_tracer = get_tracer()


def _params_device(params) -> Optional[torch.device]:
    for leaf in pytree.tree_leaves(params):
        t = getattr(leaf, "q", leaf)  # a QTensor's payload
        if isinstance(t, torch.Tensor):
            return t.device
    return None


def _to_host(y):
    return pytree.tree_map(
        lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
        else np.asarray(a), y)


class ServingEngine:
    """Serve a built module.

    Args:
        module: a built ``nn.Module`` (``build()`` already called: the
            engine freezes the params/buffers it finds), on ``device``.
        input_shape: per-example input shape (no batch dim); needed by
            ``warmup`` before the first request arrives, else inferred
            from traffic.
        buckets: batch-dim shape buckets; default powers of two up to
            ``max_batch_size``.
        max_batch_size: device batch ceiling; default ``max(buckets)``
            or 32.
        max_wait_ms: how long a partial batch waits for company.
        max_queue: bounded queue depth (backpressure beyond it).
        dtype: wire/device input dtype (default float32).
        platform: the reference's JAX platform pin; the port takes
            ``device`` instead, and only None is accepted.
        donate_x: kept for the reference's signature; a graph already
            reuses its static input buffer.
        use_shared_pool: run the batching worker on the shared Engine
            host pool instead of a private thread.
        name: label for traces, metrics, the memory ledger and
            fault-injection filters (``resilience.ReplicaSet`` names its
            members r0..rN-1).
        with_batcher: when False the engine is built WITHOUT its own
            DynamicBatcher: batches arrive through ``_run_batch`` from an
            external dispatcher (the ReplicaSet mode).
        placement: a
            :class:`~bigdl_tpu_torch.serving.placement.MeshSlice`, the
            engine's slot (see the module docstring); its device is the
            engine's, and a slot that does not hold this process raises
            ``PlacementError``.  None keeps the unplaced engine.
        tp_rules: ``rules(path, leaf) -> NamedSharding | None``
            overriding the derived ``serving_tp_rules`` of a ``tp > 1``
            slot.
        cuda_graphs: one captured graph per bucket (default: on a CUDA
            device, unless the slot is tensor-parallel); False runs every
            batch eagerly.
        device: where the module's params live and batches run (default
            the card; under placement, the slot's).
    """

    def __init__(self, module, *,
                 input_shape: Optional[tuple] = None,
                 buckets: Optional[Sequence[int]] = None,
                 max_batch_size: Optional[int] = None,
                 max_wait_ms: float = 5.0,
                 max_queue: int = 256,
                 dtype="float32",
                 platform: Optional[str] = None,
                 donate_x: bool = False,
                 max_cache_entries: int = 16,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 use_shared_pool: bool = True,
                 name: str = "engine",
                 with_batcher: bool = True,
                 placement=None,
                 tp_rules=None,
                 cuda_graphs: Optional[bool] = None,
                 device=None):
        if platform is not None:
            raise ValueError("platform= pins a JAX backend; pass device= "
                             "('cuda' or 'cpu') instead")
        module._built()
        tp = 1 if placement is None else placement.tp
        if placement is not None:
            # raises PlacementError for a slot this process does not hold
            self.device = placement.device
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device={device} but the placement slot "
                                 f"is on {self.device}")
        else:
            self.device = resolve_device(device)
            where = _params_device(module.params)
            if where is not None and where != self.device:
                raise ValueError(f"engine on {self.device}, but the "
                                 f"module's params live on {where}")
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda" and tp == 1
        elif cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs=True needs a CUDA device, the "
                             f"engine is on {self.device}")
        elif cuda_graphs and tp > 1:
            raise ValueError("cuda_graphs=True with a tensor-parallel slot: "
                             "its batches run eagerly (DTensor dispatch and "
                             "its collectives are not captured)")
        self.cuda_graphs = bool(cuda_graphs)
        self.module = module
        self.name = name
        self.placement = placement
        # freeze: the engine holds its own references; later training
        # steps rebind module.params and never touch these
        self._params = module.params
        self._buffers = module.buffers
        self._dtype = np.dtype(dtype)
        self.input_shape = tuple(input_shape) if input_shape else None

        # a quantized replica (module.quantize()) serves its int8 payload
        # as the LM engine does: on the device, its bytes counted
        self.quant_dtype = params_dtype_tag(self._params)
        self._quant_bytes_staged = 0
        if placement is not None:
            # one chunked pass straight to the slot's layout
            from bigdl_tpu_torch.serving.placement import (
                serving_tp_rules, shard_params_chunked)
            if tp_rules is None and tp > 1:
                tp_rules = serving_tp_rules(module, placement.mesh)
            self._params = shard_params_chunked(
                self._params, tp_rules or (lambda path, leaf: None),
                placement, chunk_bytes=chunk_bytes)
            self._buffers = shard_params_chunked(
                self._buffers, lambda path, leaf: None, placement,
                chunk_bytes=chunk_bytes)
            if self.quant_dtype == "int8":
                self._quant_bytes_staged = params_nbytes(self._params)
                get_registry().gauge("quant/serving_bytes_staged", unit="B") \
                    .set(self._quant_bytes_staged)
        elif self.quant_dtype == "int8":
            self._params, self._quant_bytes_staged = stage_quantized_params(
                self._params, device=self.device)
            get_registry().gauge("quant/serving_bytes_staged", unit="B") \
                .set(self._quant_bytes_staged)

        if max_batch_size is None:
            max_batch_size = max(buckets) if buckets else 32
        if buckets is None:
            buckets = power_of_two_buckets(max_batch_size)
        if max(buckets) < max_batch_size:
            raise ValueError(
                f"largest bucket {max(buckets)} < max_batch_size "
                f"{max_batch_size}: every dispatch must fit a bucket")
        # kept on the engine: batcher-less replica members need them for
        # warmup, and an external dispatcher (ReplicaSet) reads them
        self.max_batch_size = int(max_batch_size)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))

        rng = keychain.prng_key(0)  # inert: training=False paths

        def _infer(params, buffers, x):
            # expand non-native QTensors at the entry (identity for a
            # float tree); native ones dequantize in their products
            y, _ = module.apply(dequantize_entry(params), x,
                                buffers=buffers, training=False, rng=rng)
            return y

        if tp > 1:
            # the batch enters replicated on the slot's mesh (DTensor ops
            # refuse plain operands); a col-parallel tail leaves the
            # output sharded: made whole for the host pull
            mesh, unplaced = placement.mesh, _infer

            def _infer(params, buffers, x):
                return unplaced(params, buffers, pytree.tree_map(
                    lambda t: replicate_on(t, mesh), x))

            _infer = sharded_step(_infer)

        self.graphs = GraphPool(self.device, capture=self.cuda_graphs)
        self.cache = CompileCache(
            _infer, graphs=self.graphs, max_entries=max_cache_entries,
            placement_tag=placement.tag if placement is not None else "",
            name=f"serve/{name}/infer")
        self.stager = HostStager(self._dtype, chunk_bytes=chunk_bytes,
                                 device=self.device)
        # live metrics, published into the process-wide obs registry
        # (latest engine owns the serving/* names)
        self.metrics = ServingMetrics().publish_to(get_registry())
        self._ledger_keys = self._register_ledger()
        # dispatch-cadence stall detection; every knob from this
        # engine's environment: an unset one takes its default, not the
        # value an earlier user of the shared watchdog left behind
        self.watchdog = (shared_watchdog("serve_dispatch")
                         .reset(**{"k": 10.0, "deadline_s": None,
                                   **env_watchdog_kwargs()})
                         if env_watchdog_enabled() else None)
        self.batcher = None
        if with_batcher:
            self.batcher = DynamicBatcher(
                self._run_batch,
                max_batch_size=max_batch_size,
                max_wait_ms=max_wait_ms,
                max_queue=max_queue,
                buckets=buckets,
                metrics=self.metrics,
                pool=Engine.default_or_create() if use_shared_pool else None,
                lockstep=placement.lockstep() if tp > 1 else None)
        self._closed = False

    def _register_ledger(self) -> list:
        """Memory-ledger rows: the staged params, the stager's
        cumulative traffic and, with capture on, the graph pool (held
        weakly; ``close`` releases them)."""
        keys = []
        try:
            from bigdl_tpu_torch.obs.ledger import get_ledger
            led = get_ledger()
            name = self.name
            dev = self.placement.tag if self.placement is not None else None
            keys.append(led.register(
                "params", f"{name}/staged", params_nbytes(self._params),
                device=dev, note=f"quant={self.quant_dtype}"))
            stager_ref = weakref.ref(self.stager)

            def _staged_bytes():
                st = stager_ref()
                return st.bytes_staged if st is not None else None

            keys.append(led.register(
                "host_stager", f"{name}/bytes_staged", _staged_bytes,
                device=dev, note="cumulative h2d traffic"))
            if self.graphs.capture:
                graphs_ref = weakref.ref(self.graphs)

                def _pool_bytes():
                    g = graphs_ref()
                    return g.pool_bytes() if g is not None else None

                keys.append(led.register(
                    "graphs", f"{name}/graph_pool", _pool_bytes, device=dev,
                    note="CUDA-graph pool of the padded-batch engine"))
        except Exception:
            pass
        return keys

    # ------------------------------------------------------------------ #
    def _run_batch(self, x_padded: np.ndarray):
        """Batcher callback: stage, run the bucket's entry, copy the
        outputs to the host (which also synchronises)."""
        if self.watchdog is not None:
            self.watchdog.step_started()
        try:
            # replica death and latency spikes inject here (filtered by
            # this engine's name), before any device work
            from bigdl_tpu_torch.resilience.faults import fault_point
            rows = int(x_padded.shape[0])
            fault_point("serving.dispatch", name=self.name, rows=rows)
            misses0 = (self.cache.stats()["misses"] if _tracer.enabled
                       else 0)
            with torch.cuda.device(self.device) \
                    if self.device.type == "cuda" \
                    else contextlib.nullcontext():
                with _tracer.span("serve/h2d", cat="serve", rows=rows):
                    if self.graphs.capture:
                        self.stager.count(x_padded)
                        xd = np.asarray(x_padded, self._dtype)
                    else:
                        xd = self.stager.stage(x_padded)
                y = self.cache(self._params, self._buffers, xd)
                if _tracer.enabled:
                    miss = self.cache.stats()["misses"] > misses0
                    _tracer.instant(
                        "serve/cache_miss" if miss else "serve/cache_hit",
                        cat="serve", bucket=rows)
                # every leaf must carry the batch dim first or the
                # batcher's slice-back would hand requests wrong rows
                leaves = pytree.tree_leaves(y)
                if not leaves:
                    raise TypeError("model output has no array leaves")
                for leaf in leaves:
                    if not hasattr(leaf, "shape") or leaf.ndim < 1 \
                            or int(leaf.shape[0]) != rows:
                        got = (tuple(leaf.shape) if hasattr(leaf, "shape")
                               else type(leaf))
                        raise TypeError(
                            f"every output leaf needs a leading batch dim "
                            f"of {rows}; got {got}")
                # before the next replay reuses the graph's outputs
                return _to_host(y)
        finally:
            if self.watchdog is not None:
                self.watchdog.step_finished()

    def forwarded(self, op: str, *args):
        """A slot rank's side of a forwarded replica set
        (``serving.placement.forward``): run the driver's ``op`` on this
        engine, in the order the driver handed them out.  ``"run"`` a
        padded batch (its rows back to the driver; the ``serving.dispatch``
        fault site fires here), ``"warmup"`` a shape, ``"describe"`` what
        the driver's handle needs, ``"cache_stats"``."""
        if op == "run":
            return self._run_batch(args[0])
        if op == "warmup":
            return self.warmup(args[0])
        if op == "describe":
            return dict(input_shape=self.input_shape,
                        max_batch_size=self.max_batch_size,
                        buckets=self.buckets, dtype=self._dtype.str)
        if op == "cache_stats":
            return self.cache.stats()
        raise ValueError(f"unknown forwarded op {op!r}")

    def _coerce(self, x, batched: bool) -> np.ndarray:
        x = np.asarray(x, self._dtype)
        if not batched:
            x = x[None]
        if self.input_shape is None and x.ndim >= 1:
            self.input_shape = tuple(x.shape[1:])
        return x

    # ------------------------------------------------------------------ #
    def warmup(self, input_shape: Optional[tuple] = None) -> int:
        """Make the entry of every configured bucket (a capture on the
        card) so the first real request pays none; returns how many were
        made.  After a full warmup a bucketed workload's cache hit rate
        is 1.0."""
        shape = tuple(input_shape) if input_shape else self.input_shape
        if shape is None:
            raise ValueError("warmup needs input_shape (none configured "
                             "and no request seen yet)")
        self.input_shape = shape
        inputs = [np.zeros((b,) + shape, self._dtype) for b in self.buckets]
        return self.cache.warmup_inputs(self._params, self._buffers, inputs)

    def submit(self, x, *, batched: bool = True) -> Future:
        """Async: enqueue a request (a batch by default), get a Future
        of the output batch.  Raises ServingQueueFull on backpressure."""
        if self._closed:
            raise ServingClosed("engine is closed")
        if self.batcher is None:
            raise RuntimeError(
                "this engine has no batcher (with_batcher=False): it is "
                "a ReplicaSet member; submit through the ReplicaSet")
        return self.batcher.submit(self._coerce(x, batched))

    def predict(self, x, *, timeout: Optional[float] = None) -> np.ndarray:
        """Sync: serve one batch through the same queue as submit()."""
        return self.submit(x).result(timeout=timeout)

    def predict_one(self, x, *,
                    timeout: Optional[float] = None) -> np.ndarray:
        """Sync single example: adds and strips the batch dim."""
        fut = self.submit(self._coerce(x, batched=False), batched=True)
        return pytree.tree_map(lambda a: a[0], fut.result(timeout=timeout))

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        out = {
            "name": self.name,
            "pending": self.batcher.pending() if self.batcher else 0,
            "buckets": list(self.buckets),
            "quant_dtype": self.quant_dtype,
            "quant_bytes_staged": self._quant_bytes_staged,
            "placement": (self.placement.describe()
                          if self.placement is not None else None),
            "compile_cache": self.cache.stats(),
            "cuda_graphs": self.graphs.stats(),
            "host_transfer": self.stager.stats(),
            "metrics": self.metrics.snapshot(self.cache.stats()),
        }
        if self.watchdog is not None:
            out["watchdog"] = {"stalls": self.watchdog.stall_count,
                               "median_dispatch_s": self.watchdog.median()}
        return out

    def export_metrics(self, summary, step: int) -> None:
        """Write the current snapshot through a visualization Summary."""
        self.metrics.export_to_summary(summary, step, self.cache.stats())

    def close(self, timeout: Optional[float] = 30.0) -> None:
        self._closed = True
        if self.batcher is not None:
            self.batcher.close(timeout=timeout)
        try:
            from bigdl_tpu_torch.obs.ledger import get_ledger
            led = get_ledger()
            for sub, nm in self._ledger_keys:
                led.release(sub, nm)
        except Exception:
            pass

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

