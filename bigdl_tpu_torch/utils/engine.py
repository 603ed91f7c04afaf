"""Engine: the process's host thread pools and topology (port of the
host half of ``bigdl_tpu/utils/engine.py``; ref utils/Engine.scala
84-445 and utils/ThreadPool.scala).

``Engine.default`` is the shared host pool the serving batchers run
their workers on (``use_shared_pool``) and the data pipeline may use;
``Engine.model`` a pool of one thread per device.  ``core_number``
counts CUDA devices (1 on the CPU).  The reference's platform pinning,
virtual devices and ``diagnose_tpu`` belong to its TPU backend; the
port's ``device.diagnose_cuda`` takes ``diagnose_tpu``'s place.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Callable, Optional, Sequence


class ThreadPool:
    """Host-side task pool (ref utils/ThreadPool.scala:92-168)."""

    def __init__(self, size: int):
        self._size = size
        self._pool = ThreadPoolExecutor(max_workers=size,
                                        thread_name_prefix="bigdl-torch")

    @property
    def size(self) -> int:
        return self._size

    def invoke(self, tasks: Sequence[Callable]) -> list[Future]:
        return [self._pool.submit(t) for t in tasks]

    def invoke_and_wait(self, tasks: Sequence[Callable]) -> list:
        return [f.result() for f in self.invoke(tasks)]

    def invoke_and_wait2(self, tasks: Sequence[Callable],
                         timeout: Optional[float] = None) -> list[Future]:
        """Submit all tasks, wait up to ``timeout`` seconds; returns
        futures (some possibly unfinished: the caller decides what to
        drop).  Only timeouts are swallowed; a task that raised re-raises
        here after every other task has been waited on."""
        futures = self.invoke(tasks)
        first_error: Optional[Exception] = None
        for f in futures:
            try:
                f.result(timeout=timeout)
            except FuturesTimeoutError:
                pass  # straggler: caller inspects f.done() and drops it
            except Exception as e:
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error
        return futures

    def sync(self, futures: Sequence[Future]) -> None:
        for f in futures:
            f.result()

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)


class _EngineState:
    def __init__(self):
        self.lock = threading.Lock()
        self.singleton_claimed = False
        self.initialized = False
        self.node_number = 1
        self.core_number = 1
        self.default_pool: Optional[ThreadPool] = None
        self.model_pool: Optional[ThreadPool] = None


_state = _EngineState()


def _default_pool_size(size: Optional[int] = None) -> int:
    return size or int(os.environ.get("BIGDL_TPU_DEFAULT_POOL_SIZE",
                                      str(max(os.cpu_count() or 4, 4))))


class Engine:
    """Singleton runtime facade (ref utils/Engine.scala:84-99,142-146)."""

    @staticmethod
    def init(node_number: Optional[int] = None,
             core_number: Optional[int] = None,
             platform: Optional[str] = None) -> None:
        """Set up the topology: one node (this process) and
        ``core_number`` devices (``DL_CORE_NUMBER``, else the CUDA device
        count, 1 on the CPU or with ``platform="cpu"``), and the host
        pools."""
        if platform not in (None, "cpu", "cuda", "gpu"):
            raise ValueError(f"platform must be 'cpu', 'cuda' or 'gpu', "
                             f"got {platform!r}")
        from bigdl_tpu_torch.resilience.faults import fault_point
        fault_point("engine.init")
        with _state.lock:
            if node_number is None:
                node_number = 1
            if core_number is None:
                if os.environ.get("DL_CORE_NUMBER"):
                    core_number = int(os.environ["DL_CORE_NUMBER"])
                elif platform == "cpu":
                    core_number = 1
                else:
                    import torch
                    core_number = max(torch.cuda.device_count(), 1)
            _state.node_number = node_number
            _state.core_number = core_number
            if _state.default_pool is None:
                _state.default_pool = ThreadPool(_default_pool_size())
            if _state.model_pool is None:
                _state.model_pool = ThreadPool(core_number)
            _state.initialized = True

    @staticmethod
    def node_number() -> int:
        Engine._require_init()
        return _state.node_number

    @staticmethod
    def core_number() -> int:
        Engine._require_init()
        return _state.core_number

    @staticmethod
    def default() -> ThreadPool:
        Engine._require_init()
        return _state.default_pool  # type: ignore[return-value]

    @staticmethod
    def default_or_create(size: Optional[int] = None) -> ThreadPool:
        """The shared host pool, created lazily if ``Engine.init`` has
        not run yet; a later ``init`` adopts the same pool."""
        with _state.lock:
            if _state.default_pool is None:
                _state.default_pool = ThreadPool(_default_pool_size(size))
            return _state.default_pool

    @staticmethod
    def model() -> ThreadPool:
        Engine._require_init()
        return _state.model_pool  # type: ignore[return-value]

    @staticmethod
    def check_singleton() -> bool:
        """Atomic guard: only one Engine owner per process (ref
        utils/Engine.scala:164-174)."""
        if os.environ.get("BIGDL_TPU_CHECK_SINGLETON", "1") in ("0",
                                                               "false"):
            return True
        with _state.lock:
            if _state.singleton_claimed:
                return False
            _state.singleton_claimed = True
            return True

    @staticmethod
    def reset() -> None:
        """Test hook: clear init + singleton state."""
        with _state.lock:
            _state.initialized = False
            _state.singleton_claimed = False
            _state.node_number = 1
            _state.core_number = 1

    @staticmethod
    def is_initialized() -> bool:
        return _state.initialized

    @staticmethod
    def _require_init() -> None:
        if not _state.initialized:
            raise RuntimeError("Engine.init() must be called before use")
