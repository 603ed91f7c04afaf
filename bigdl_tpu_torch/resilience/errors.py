"""Failure taxonomy (port of ``bigdl_tpu/resilience/errors.py``).

Every resilience decision (retry, shed, fail over, give up) hinges on
one question about an exception: is it transient (the same call can
succeed), is the backend gone (retrying cannot help), or is it a
programming error (retrying anywhere is wrong)?  ``classify_error``
answers it from the exception type and message.
"""
from __future__ import annotations


class TransientBackendError(RuntimeError):
    """A retryable failure: the operation may succeed if repeated."""


class BackendLostError(RuntimeError):
    """The backend is gone for this process: retries cannot help."""


class ServingOverloaded(TransientBackendError):
    """Typed overload rejection: backpressure or admission control shed
    this request at enqueue.  Transient in the taxonomy: the server is
    healthy but saturated, so the same request can succeed once load
    drains.  Every raise at an admission seam increments the
    ``serving/rejected_total`` registry counter
    (``serving.errors.count_rejection``)."""


class ServingDeadlineExceeded(ServingOverloaded):
    """A request's wall-clock budget (``deadline_s``, minted at enqueue)
    expired before the server started useful work on it, so admission
    control shed it.  A :class:`ServingOverloaded`, so every shed
    accounting path treats a blown deadline like a backpressure
    rejection."""


#: substrings that mark a retryable failure
TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "INTERNAL",
    "RESOURCE_EXHAUSTED",
    "Socket closed",
    "failed to connect",
    "Connection reset",
)

#: substrings that mean the backend will not come back for this process
BACKEND_LOST_MARKERS = (
    "Unable to initialize backend",
    "backend lost",
    "Backend lost",
    "backend has been shut down",
)

#: exception types that indicate a bug, not a backend
_FATAL_TYPES = (TypeError, ValueError, KeyError, IndexError,
                AttributeError, NotImplementedError, AssertionError)


def classify_error(exc: BaseException) -> str:
    """``"transient"`` | ``"backend_lost"`` | ``"fatal"``.

    Explicit resilience types win; then marker matching on ``type:
    message``; unknown exceptions are fatal (silently retrying a novel
    failure is how a bug hides as flakiness)."""
    if isinstance(exc, BackendLostError):
        return "backend_lost"
    if isinstance(exc, TransientBackendError):
        return "transient"
    if isinstance(exc, _FATAL_TYPES):
        return "fatal"
    msg = f"{type(exc).__name__}: {exc}"
    for marker in BACKEND_LOST_MARKERS:
        if marker in msg:
            return "backend_lost"
    for marker in TRANSIENT_MARKERS:
        if marker in msg:
            return "transient"
    return "fatal"
