"""Bounded exponential backoff around backend-touching calls (port of
``bigdl_tpu/resilience/retry.py``).

Transient failures retry with exponentially growing delays, a bounded
number of times; a lost backend surfaces at once as
:class:`BackendLostError` for the caller's failover path; fatal
(programming) errors pass through untouched.  Every retry and every
terminal loss is counted in the process-wide registry under
``resilience/retries`` and ``resilience/backend_lost``.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Optional

from bigdl_tpu_torch.resilience.errors import BackendLostError, classify_error

log = logging.getLogger("bigdl_tpu_torch.resilience")


def with_backoff(fn: Callable, *,
                 retries: int = 4,
                 base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0,
                 classify: Callable = classify_error,
                 on_transient: Optional[Callable] = None,
                 label: str = "operation",
                 sleep: Callable = time.sleep):
    """Run ``fn()`` and return its result, retrying transient failures.

    ``retries`` bounds the extra attempts (at most ``retries + 1``
    calls); delays double from ``base_delay_s`` up to ``max_delay_s``.
    ``on_transient(attempt, exc)`` runs before each retry (the chunked
    transfer halves its chunk there).  Exhausted retries escalate to
    :class:`BackendLostError`, chained to the last transient."""
    from bigdl_tpu_torch.obs import get_registry
    reg = get_registry()
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - classification decides
            kind = classify(e)
            if kind == "fatal":
                raise
            if kind == "backend_lost":
                reg.counter("resilience/backend_lost").add(1)
                if isinstance(e, BackendLostError):
                    raise
                raise BackendLostError(f"{label}: backend lost: {e}") from e
            last = e
            if attempt >= retries:
                break
            reg.counter("resilience/retries").add(1)
            delay = min(max_delay_s, base_delay_s * (2 ** attempt))
            log.warning("%s: transient failure (attempt %d/%d), retrying "
                        "in %.2fs: %s", label, attempt + 1, retries + 1,
                        delay, e)
            if on_transient is not None:
                on_transient(attempt, e)
            sleep(delay)
    reg.counter("resilience/backend_lost").add(1)
    raise BackendLostError(
        f"{label}: still failing after {retries + 1} attempts "
        f"(bounded backoff exhausted): {last}") from last
