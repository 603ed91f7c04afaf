"""Dynamic request batcher: bounded queue, max-batch/max-wait policy,
power-of-two shape buckets, backpressure (port of
``bigdl_tpu/serving/batcher.py``).

BigDL's serving story (arXiv 1804.05839) is batched forward passes over
a shared immutable model; under CUDA graphs, as under XLA, every novel
batch shape is a fresh capture, so the batcher rounds every dispatch UP
to a configured bucket (powers of two by default) and the graph cache
stays small and warm.  Policy knobs follow the classic
serving trade-off: ``max_batch_size`` bounds device latency,
``max_wait_ms`` bounds queueing latency (a lone request is flushed when
its wait expires — the empty-queue timeout flush), and the bounded
queue rejects with an error instead of growing without bound when the
device falls behind (backpressure beats OOM).

Ordering is deterministic: responses complete in submission order —
one worker drains the FIFO queue and resolves futures sequentially.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.obs.tracer import (clear_request_context, get_tracer,
                                        mint_request_id, set_request_context)
from bigdl_tpu_torch.resilience.errors import (ServingDeadlineExceeded,
                                               ServingOverloaded,
                                               TransientBackendError)
from bigdl_tpu_torch.serving.errors import (ServingClosed,  # noqa: F401
                                            ServingQueueFull,
                                            count_rejection)
from bigdl_tpu_torch.utils import pytree

_tracer = get_tracer()


def power_of_two_buckets(max_batch_size: int) -> tuple:
    """1, 2, 4, ... up to (and always including) max_batch_size."""
    buckets = []
    b = 1
    while b < max_batch_size:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch_size)
    return tuple(buckets)


def _tree_np(y):
    """A model output (an array or any nest of arrays: multi-headed
    models, Tables) as host numpy, leaf-wise."""
    return pytree.tree_map(np.asarray, y)


def _tree_slice(y, lo: int, hi: int):
    """Row-slice every leaf: the per-request slice-back."""
    return pytree.tree_map(lambda a: a[lo:hi], y)


def _tree_concat(parts: list):
    """Concatenate chunked outputs leaf-wise along the batch dim."""
    return pytree.tree_map(lambda *leaves: np.concatenate(leaves, 0),
                           *parts)


class _Request:
    __slots__ = ("x", "n", "future", "t_enqueue", "rid", "deadline_at",
                 "key")

    def __init__(self, x, n: int, future: Future, rid: str,
                 deadline_at: Optional[float] = None,
                 key: Optional[int] = None):
        self.key = key  # the lockstep key (tensor-parallel slots only)
        self.x = x
        self.n = n
        self.future = future
        self.t_enqueue = time.perf_counter()
        self.rid = rid
        # absolute monotonic deadline, minted at enqueue (None = no
        # budget): checked when the batch is ASSEMBLED, so an expired
        # request is shed before it costs a device dispatch
        self.deadline_at = deadline_at


def _safe_resolve(future: Future, *, result=None, exc=None) -> None:
    """Resolve a future exactly once, tolerating cancellation and the
    close()-timeout sweep racing a late worker (InvalidStateError)."""
    if future.cancelled():
        return
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
    except Exception:
        pass  # already resolved by the other side of the race


class DynamicBatcher:
    """Gathers requests into bucket-padded batches for ``run_batch``.

    ``run_batch(x_padded) -> y_padded`` sees only bucket-shaped arrays
    (leading dim in ``buckets``); the batcher pads with zero rows and
    slices the per-request outputs back out.  The output may be a
    single array or any pytree of arrays (multi-headed models, Tables)
    whose every leaf carries the batch dim first — slice-back and
    oversized-chunk reassembly are leaf-wise.  A single request larger
    than ``max_batch_size`` is served alone, chunked into
    ``max_batch_size`` slices (each slice still bucket-shaped).

    ``lockstep`` (a tensor-parallel slot's ``MeshSlice.lockstep()``)
    makes the ranks of one slot dispatch the same batches: each round is
    decided by the slot (``placement.lockstep``), not by this rank's
    clock.  A batch is the run of requests every rank holds, cut at
    ``max_batch_size``; it goes when full, when the lead rank's oldest
    request has waited ``max_wait_ms``, or at close.  Cancels, deadlines
    and refusals seen on any rank retire the request on all of them.
    """

    def __init__(self, run_batch: Callable, *,
                 max_batch_size: int = 32,
                 max_wait_ms: float = 5.0,
                 max_queue: int = 256,
                 buckets: Optional[Sequence[int]] = None,
                 metrics=None,
                 pool=None,
                 lockstep=None):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self._run = run_batch
        self._ls = lockstep
        self._max_batch = int(max_batch_size)
        self._max_wait = max(0.0, float(max_wait_ms)) / 1000.0
        self._max_queue = int(max_queue)
        self.buckets = tuple(sorted(set(int(b) for b in (
            buckets if buckets is not None
            else power_of_two_buckets(max_batch_size)))))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError("buckets must be positive ints")
        self._metrics = metrics
        self._queue: "deque[_Request]" = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._inflight: list = []  # requests inside the current dispatch
        self._worker_done = Future()
        if pool is not None:
            # reuse the shared Engine host pool (one long-running slot)
            pool.invoke([self._loop_guard])
        else:
            threading.Thread(target=self._loop_guard, daemon=True,
                             name="bigdl-torch-batcher").start()
        # flight-recorder hookup (latest batcher wins the key; weakref
        # so the provider never keeps a closed batcher alive)
        try:
            from bigdl_tpu_torch.obs import flight
            import weakref
            wself = weakref.ref(self)

            def _active_rids():
                b = wself()
                if b is None:
                    return []
                with b._cv:
                    return ([r.rid for r in b._queue]
                            + [r.rid for r in b._inflight])
            flight.register_requests("batcher", _active_rids)
        except Exception:
            pass

    # ------------------------------------------------------------------ #
    def bucket_for(self, n: int) -> int:
        """Smallest configured bucket >= n (n must fit the largest)."""
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"no bucket holds {n} rows "
                         f"(largest is {self.buckets[-1]})")

    def submit(self, x, n: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Future:
        """Enqueue a request of ``n`` examples (leading dim of ``x``);
        raises ServingQueueFull (a ServingOverloaded) when the bounded
        queue is full.

        ``deadline_s`` is an optional wall-clock budget minted here:
        a request still queued when it expires is shed at batch
        assembly (before any device work) with the typed
        :class:`~bigdl_tpu_torch.resilience.errors.ServingDeadlineExceeded`.
        Cancelling the returned future before dispatch is likewise
        honored at assembly: the request never reaches the device."""
        x = np.asarray(x)
        if n is None:
            n = int(x.shape[0]) if x.ndim else 1
        if deadline_s is not None and float(deadline_s) <= 0.0:
            if self._metrics is not None:
                self._metrics.record_reject()
            count_rejection()
            raise ServingDeadlineExceeded(
                f"deadline_s={deadline_s} already expired at enqueue")
        # resilience hook: chaos exercises the admission path here.  An
        # injected transient is surfaced as the SAME typed shed a real
        # overload produces, so clients and the loadgen account for it
        # identically; backend_lost passes through unconverted.
        from bigdl_tpu_torch.resilience.faults import fault_point
        try:
            fault_point("serving.enqueue", n=n)
        except ServingOverloaded:
            self._refuse_key()
            raise
        except TransientBackendError as e:
            self._refuse_key()
            count_rejection()
            raise ServingOverloaded(
                f"admission shed (injected at serving.enqueue): {e}") from e
        fut: Future = Future()
        rid = mint_request_id()
        with self._cv:
            key = self._ls.key() if self._ls is not None else None
            if self._stop:
                self._refuse_key(key)
                raise ServingClosed("batcher is closed")
            if len(self._queue) >= self._max_queue:
                self._refuse_key(key)
                if self._metrics is not None:
                    self._metrics.record_reject()
                count_rejection()
                raise ServingQueueFull(
                    f"request queue full ({self._max_queue} pending); "
                    "retry later or raise max_queue")
            self._queue.append(_Request(
                x, n, fut, rid,
                deadline_at=(time.monotonic() + float(deadline_s)
                             if deadline_s is not None else None),
                key=key))
            depth = len(self._queue)
            self._cv.notify()
        fut.request_id = rid  # clients correlate responses with traces
        if self._metrics is not None:
            self._metrics.record_submit()
        if _tracer.sampled(rid):
            _tracer.instant("serve/enqueue", cat="serve", n=n,
                            queue_depth=depth, request_id=rid)
        else:
            _tracer.instant("serve/enqueue", cat="serve", n=n,
                            queue_depth=depth)
        return fut

    def _refuse_key(self, key: Optional[int] = None) -> None:
        """A lockstep batcher's refused submission: its key is drawn (if
        not yet) and named to the other ranks, which retire their copy."""
        if self._ls is None:
            return
        if key is None:
            with self._cv:
                key = self._ls.key()
        self._ls.refuse(key)

    def pending(self) -> int:
        with self._cv:
            return len(self._queue)

    def set_max_queue(self, n: int) -> None:
        """Admission-control actuator: rebind the queue bound live.  The
        SLO controller shrinks it when saturated (shed instead of queue
        collapse) and restores it once p99 recovers; already-queued
        requests are never dropped, only new arrivals see the bound."""
        with self._cv:
            self._max_queue = max(0, int(n))

    @property
    def max_queue(self) -> int:
        with self._cv:
            return self._max_queue

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting requests, drain what is queued, join the
        worker.  GUARANTEE: no accepted request's future is left
        hanging — if the worker cannot finish the drain inside
        ``timeout`` (e.g. the device call is wedged against a dead
        tunnel), every still-unresolved queued AND in-flight future is
        failed with :class:`ServingClosed` before close returns."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        try:
            self._worker_done.result(timeout=timeout)
        except Exception:
            # drain timed out: sweep everything still unresolved.  A
            # late worker completion races these sets; both sides go
            # through _safe_resolve, so whichever lands first wins and
            # the loser is a no-op.
            with self._cv:
                leftovers = list(self._queue) + list(self._inflight)
                self._queue.clear()
            for r in leftovers:
                _safe_resolve(r.future, exc=ServingClosed(
                    "batcher closed before this request was served"))

    # ------------------------------------------------------------------ #
    def _loop_guard(self) -> None:
        try:
            self._loop()
        finally:
            # requests that raced past the close gate still get answers
            with self._cv:
                leftovers = list(self._queue)
                self._queue.clear()
            for r in leftovers:
                _safe_resolve(r.future,
                              exc=ServingClosed("batcher closed"))
            try:
                self._worker_done.set_result(None)
            except Exception:
                pass  # a crashed-and-restarted guard already resolved it

    def _shed_dead(self, r: _Request) -> bool:
        """Lifecycle gate at batch assembly: a cancelled future or a
        blown deadline never reaches the device.  Returns True when
        the request was consumed (shed) here."""
        why = self._dead_reason(r, time.monotonic())
        if why is not None:
            self._shed(r, why)
        return why is not None

    @staticmethod
    def _dead_reason(r: _Request, now: float) -> Optional[str]:
        if r.future.cancelled():
            return "cancelled"
        if r.deadline_at is not None and now >= r.deadline_at:
            return "deadline"
        return None

    def _shed(self, r: _Request, why: str) -> None:
        """Retire a queued request: ``why`` is "cancelled", "deadline",
        or "refused" (another rank of a lockstep slot refused it)."""
        if why == "refused":
            _safe_resolve(r.future, exc=ServingOverloaded(
                "refused at submission by another rank of the slot"))
            return
        if why == "cancelled":
            r.future.cancel()  # another rank's cancel: this copy too
            from bigdl_tpu_torch.obs import get_registry
            get_registry().counter("serving/lifecycle/cancelled").add(1)
            if _tracer.sampled(r.rid):
                _tracer.instant("serve/lifecycle_shed", cat="serve",
                                request_id=r.rid, reason="cancelled")
            return
        if self._metrics is not None:
            self._metrics.record_reject()
        count_rejection()
        from bigdl_tpu_torch.obs import get_registry
        get_registry().counter(
            "serving/lifecycle/expired_preadmission").add(1)
        _safe_resolve(r.future, exc=ServingDeadlineExceeded(
            "deadline expired while queued; request shed before "
            "dispatch"))
        if _tracer.sampled(r.rid):
            _tracer.instant("serve/lifecycle_shed", cat="serve",
                            request_id=r.rid, reason="deadline")

    def _take_batch(self) -> Optional[list]:
        """Block for the first request, then gather until the batch is
        full or the oldest request's wait budget expires.  Requests
        whose future was cancelled or whose deadline expired while
        queued are shed here, before any device work."""
        with self._cv:
            while True:
                while not self._queue:
                    if self._stop:
                        return None
                    self._cv.wait(timeout=0.05)
                first = self._queue.popleft()
                if not self._shed_dead(first):
                    break
            if first.n >= self._max_batch:
                return [first]  # full (or oversized: served alone, chunked)
            batch, total = [first], first.n
            deadline = first.t_enqueue + self._max_wait
            while total < self._max_batch:
                if self._queue:
                    nxt = self._queue[0]
                    if total + nxt.n > self._max_batch:
                        break  # never split a request across batches
                    r = self._queue.popleft()
                    if self._shed_dead(r):
                        continue
                    batch.append(r)
                    total += r.n
                    continue
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or self._stop:
                    break  # timeout flush (possibly a partial batch)
                self._cv.wait(timeout=min(remaining, 0.05))
            return batch

    def _take_round(self, idle: bool) -> Optional[list]:
        """The lockstep batcher's take: one round of the slot (see the
        class docstring).  Returns the batch, [] when the round runs
        none, None once every rank is closing and no batch is left.
        ``idle``: the last round ran nothing, so wait a little first."""
        ls = self._ls
        with self._cv:
            if idle and not self._stop:
                wait = ls.IDLE_S
                if self._queue:
                    wait = min(wait, max(0.0, self._queue[0].t_enqueue
                                         + self._max_wait
                                         - time.perf_counter()))
                self._cv.wait(wait)
            now = time.monotonic()
            queued = [r.key for r in self._queue]
            dead = {r.key: why for r in self._queue
                    for why in (self._dead_reason(r, now),) if why}
            flush = bool(self._queue) and (
                time.perf_counter() - self._queue[0].t_enqueue
                >= self._max_wait)
            closing = self._stop
        rnd = ls.round(queued, dead, closing, flush=flush)
        with self._cv:
            live = []
            for r in self._queue:
                why = rnd.dead.get(r.key)
                if why is None:
                    live.append(r)
                else:
                    self._shed(r, why)
            self._queue = deque(live)
            if not rnd.admit:
                return None if rnd.closing else []
            # the batch rule of _take_batch, over the keys all ranks hold
            # (the queue's front, in order)
            take, total = 0, 0
            for r in list(self._queue)[:len(rnd.admit)]:
                if take and total + r.n > self._max_batch:
                    break
                take, total = take + 1, total + r.n
                if total >= self._max_batch:
                    break
            full = total >= self._max_batch or take < len(rnd.admit)
            if not (full or rnd.leader["flush"] or rnd.closing):
                return []
            return [self._queue.popleft() for _ in range(take)]

    def _dispatch(self, xs: list, bucket: int, rids=()):
        """Pad a concatenated batch to ``bucket`` rows and run it.
        ``rids`` (the batch's request ids) ride the batch-level spans
        and — via the request context — reach layers below ``run_batch``
        (the ReplicaSet failover hop) that only see a padded array."""
        total = sum(int(x.shape[0]) for x in xs)
        traced = [r for r in rids if _tracer.sampled(r)]
        with _tracer.span("serve/assemble", cat="serve",
                          requests=len(xs), rows=total, bucket=bucket,
                          **({"request_ids": traced} if traced else {})):
            parts = list(xs)
            if bucket > total:
                parts.append(np.zeros(
                    (bucket - total,) + tuple(xs[0].shape[1:]),
                    xs[0].dtype))
            joined = parts[0] if len(parts) == 1 else np.concatenate(parts, 0)
        set_request_context(rids)
        try:
            with _tracer.span("serve/device", cat="serve", bucket=bucket,
                              **({"request_ids": traced} if traced
                                 else {})):
                return self._run(joined)
        finally:
            clear_request_context()

    def _serve_batch(self, batch: list) -> None:
        t_start = time.perf_counter()
        waits = [t_start - r.t_enqueue for r in batch]
        total = sum(r.n for r in batch)
        rids = [r.rid for r in batch]
        if _tracer.enabled:
            # queue-wait spans are known only now — record retroactively
            # from each request's enqueue timestamp
            for r, w in zip(batch, waits):
                args = {"n": r.n}
                if _tracer.sampled(r.rid):
                    args["request_id"] = r.rid
                _tracer.add_complete("serve/queue_wait", r.t_enqueue, w,
                                     cat="serve", args=args)
        try:
            if total > self._max_batch:
                # one oversized request: chunk through max-size slices
                (req,) = batch
                outs = []
                for i in range(0, req.n, self._max_batch):
                    piece = req.x[i:i + self._max_batch]
                    b = self.bucket_for(int(piece.shape[0]))
                    y = _tree_np(self._dispatch([piece], b, rids))
                    outs.append(_tree_slice(y, 0, int(piece.shape[0])))
                result = _tree_concat(outs)
                bucket_rows = sum(
                    self.bucket_for(min(self._max_batch, req.n - i))
                    for i in range(0, req.n, self._max_batch))
                ys = [result]
            else:
                bucket_rows = self.bucket_for(total)
                y = _tree_np(self._dispatch([r.x for r in batch],
                                            bucket_rows, rids))
                ys, off = [], 0
                for r in batch:
                    ys.append(_tree_slice(y, off, off + r.n))
                    off += r.n
        except Exception as e:
            for r in batch:
                _safe_resolve(r.future, exc=e)
            return
        device_s = time.perf_counter() - t_start
        if self._metrics is not None:
            self._metrics.record_batch(total, bucket_rows, waits, device_s)
        with _tracer.span("serve/slice_back", cat="serve",
                          requests=len(batch), rows=total):
            done = time.perf_counter()
            for r, yr in zip(batch, ys):  # submission order -> response order
                _safe_resolve(r.future, result=yr)
                if self._metrics is not None:
                    self._metrics.record_done(done - r.t_enqueue)
        if _tracer.enabled:
            # the per-request ROOT span (enqueue -> resolved): every
            # phase above nests inside it by interval containment, so
            # span_tree() gets its one top-level node for free
            for r in batch:
                if _tracer.sampled(r.rid):
                    _tracer.add_complete(
                        "serve/request", r.t_enqueue,
                        done - r.t_enqueue, cat="serve",
                        args={"request_id": r.rid, "n": r.n})

    def _loop(self) -> None:
        batch = []
        while True:
            if self._ls is None:
                batch = self._take_batch()
            else:
                batch = self._take_round(idle=not batch)
            if batch is None:
                return
            if not batch:
                continue
            with self._cv:
                self._inflight = list(batch)
            try:
                self._serve_batch(batch)
            finally:
                with self._cv:
                    self._inflight = []
