"""Chunked host-to-device staging (port of ``bigdl_tpu/utils/transfer.py``).

A host array goes to the device in slices of at most ``chunk_bytes``
(32 MB by default) along its leading axis, through one pinned staging
buffer, with one slice in flight at a time: each slice is copied into
the pinned buffer, sent with a non-blocking copy on the caller's current
stream, and the buffer is refilled only after that copy's event has
completed.  Device work the caller enqueues later on the same stream
(a scatter into the KV arenas, a graph replay) is ordered after the
copies.

Each slice crosses the ``transfer.chunk`` fault site under
:func:`~bigdl_tpu_torch.resilience.retry.with_backoff`: a transient
retries with backoff and halves the working chunk toward
``min_chunk_bytes`` (8 MB by default; each halving counted in
``resilience/transfer_downshifts``, later slices keep the smaller
size), and exhausted retries or a lost backend raise
:class:`~bigdl_tpu_torch.resilience.errors.BackendLostError` to the
caller, which releases what it allocated.  Nothing falls back: a
staging buffer that cannot be pinned raises.
"""
from __future__ import annotations

import numpy as np
import torch

from bigdl_tpu_torch.obs.tracer import get_tracer
from bigdl_tpu_torch.resilience.faults import fault_point
from bigdl_tpu_torch.resilience.retry import with_backoff

#: per-transfer ceiling: the reference's shared 32 MB slice
DEFAULT_CHUNK_BYTES = 32 << 20

#: the floor a transient halves the chunk toward
MIN_CHUNK_BYTES = 8 << 20


def _host_tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host tensor over ``a`` in ``dtype``.  A bfloat16 payload
    travels as its int16 bit pattern (numpy has no bfloat16)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == torch.bfloat16 and t.dtype == torch.int16:
        return t.view(torch.bfloat16)
    return t.to(dtype)


def chunked_device_put(x_host, dtype: torch.dtype, *, device,
                       chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                       max_retries: int = 4,
                       min_chunk_bytes: int = MIN_CHUNK_BYTES
                       ) -> torch.Tensor:
    """Stage ``x_host`` (numpy) onto ``device`` as a ``dtype`` tensor in
    slices of at most ``chunk_bytes`` along dim 0, one in flight at a
    time, and return the assembled device tensor.  A slice that fails
    transiently retries up to ``max_retries`` times, the chunk halved
    toward ``min_chunk_bytes`` before each retry.  On the CPU the slices
    are plain copies."""
    device = torch.device(device)
    src = _host_tensor(np.asarray(x_host), dtype)
    out = torch.empty(src.shape, dtype=dtype, device=device)
    if src.numel() == 0:
        return out
    n = src.shape[0] if src.dim() else 1
    flat_src = src.reshape(n, -1)
    flat_out = out.view(n, -1)
    per_row = max(1, flat_src.shape[1] * src.element_size())
    # mutable: a transient downshifts it for this slice and the rest
    state = {"chunk": max(int(chunk_bytes), per_row)}
    floor = max(1, min(int(min_chunk_bytes), state["chunk"]))
    tracer = get_tracer()
    cuda = device.type == "cuda"
    staging = done = None
    if cuda:
        # one pinned buffer for every slice (raises if it cannot be
        # pinned: no pageable fallback); a downshift only shrinks slices
        staging = torch.empty((min(state["chunk"] // per_row, n),
                               flat_src.shape[1]), dtype=dtype,
                              pin_memory=True)
        done = torch.cuda.Event()

    def downshift(attempt, exc):
        new = max(floor, state["chunk"] // 2)
        if new < state["chunk"]:
            state["chunk"] = new
            from bigdl_tpu_torch.obs import get_registry
            get_registry().counter("resilience/transfer_downshifts").add(1)
            tracer.instant("h2d/downshift", cat="transfer", chunk_bytes=new)

    def stage(i):
        rows = max(1, state["chunk"] // per_row)
        piece = flat_src[i:i + rows]
        nbytes = piece.numel() * piece.element_size()
        with tracer.span("h2d/chunk", cat="transfer", offset_rows=i,
                         rows=int(piece.shape[0]), bytes=int(nbytes)):
            fault_point("transfer.chunk", offset_rows=i,
                        rows=int(piece.shape[0]), bytes=int(nbytes))
            dst = flat_out[i:i + piece.shape[0]]
            if not cuda:
                dst.copy_(piece)
            else:
                # the previous slice's copy has to finish before its
                # staging rows are overwritten
                done.synchronize()
                buf = staging[:piece.shape[0]]
                buf.copy_(piece)
                dst.copy_(buf, non_blocking=True)
                done.record()
        return int(piece.shape[0])

    i = 0
    while i < n:
        i += with_backoff(lambda i=i: stage(i), retries=max_retries,
                          on_transient=downshift, label="h2d chunk")
    if cuda:
        done.synchronize()
    return out
