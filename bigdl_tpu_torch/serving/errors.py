"""Serving errors (copies of the reference's typed errors:
``bigdl_tpu/serving/batcher.py`` and ``serving/kvcache/blocks.py``; the
overload taxonomy is ``bigdl_tpu_torch.resilience.errors``'s, imported
here so both import paths name the same classes)."""
from __future__ import annotations

from bigdl_tpu_torch.resilience.errors import (BackendLostError,
                                               ServingDeadlineExceeded,
                                               ServingOverloaded,
                                               TransientBackendError)

__all__ = ["BackendLostError", "PoolExhausted", "RequestExceedsPool",
           "ServingClosed", "ServingDeadlineExceeded", "ServingOverloaded",
           "ServingQueueFull", "TransientBackendError", "count_rejection"]


class ServingClosed(RuntimeError):
    """The engine was closed; the request was not served."""


class ServingQueueFull(ServingOverloaded):
    """Backpressure rejection: the bounded admission queue is full.  A
    :class:`ServingOverloaded`: the same request can succeed once load
    drains."""


class PoolExhausted(RuntimeError):
    """Transient: no free KV blocks at this instant; retry after streams
    complete or the radix cache evicts unreferenced tails."""


class RequestExceedsPool(ValueError):
    """Permanent: the request's total KV need (prompt + generation
    budget, in blocks) exceeds the whole pool; it can never be
    admitted."""


def count_rejection() -> None:
    """Process-wide typed-shed accounting: every admission-seam shed
    adds one to ``serving/rejected_total``, on top of the engine's own
    ``serving/lm/rejected``.  (The reference also feeds its flight
    recorder's shed-burst trigger here, which the port does not have
    yet.)"""
    from bigdl_tpu_torch.obs import get_registry
    get_registry().counter("serving/rejected_total", unit="requests").add(1)
