"""Host-to-device staging for serving batches (port of
``bigdl_tpu/serving/host_transfer.py``).

A thin veneer over :func:`bigdl_tpu_torch.utils.transfer.chunked_device_put`
(slices of at most 32 MB through one pinned buffer) with byte and batch
counters, which the serving metrics and the memory ledger's
``host_stager`` row report.  Under CUDA graphs a batch is not staged
here: the graph's entry copies it into its own pinned buffers and static
inputs, so the engine only counts it (:meth:`HostStager.count`).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.utils.transfer import (DEFAULT_CHUNK_BYTES,
                                            chunked_device_put)


class HostStager:
    """Stages host batches onto the device with chunking + counters.
    ``device``: where batches land (default the card; ``"cpu"`` asks for
    the host)."""

    def __init__(self, dtype=None, *,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES, device=None):
        self.dtype = dtype
        self.chunk_bytes = int(chunk_bytes)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self.bytes_staged = 0
        self.batches_staged = 0

    def _wire(self, x_host: np.ndarray) -> np.dtype:
        return np.dtype(self.dtype) if self.dtype is not None \
            else x_host.dtype

    def count(self, x_host) -> None:
        """Account one batch a graph entry stages itself."""
        x_host = np.asarray(x_host)
        with self._lock:
            self.bytes_staged += int(x_host.size) * \
                self._wire(x_host).itemsize
            self.batches_staged += 1

    def stage(self, x_host) -> torch.Tensor:
        """Upload one batch; returns the device tensor."""
        x_host = np.asarray(x_host)
        dtype = torch.from_numpy(np.zeros(0, self._wire(x_host))).dtype
        out = chunked_device_put(x_host, dtype, device=self.device,
                                 chunk_bytes=self.chunk_bytes)
        self.count(x_host)
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"bytes_staged": self.bytes_staged,
                    "batches_staged": self.batches_staged,
                    "chunk_bytes": self.chunk_bytes}
