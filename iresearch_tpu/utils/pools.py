"""Object pools and a named thread pool.

Reference: core/utils/object_pool.hpp (bounded_object_pool :144,
unbounded_object_pool :379 — reusable segment writers/readers) and
core/utils/async_utils.hpp:54 (fixed ThreadPool with named threads) +
wait_group.hpp. This build's writer pools transaction contexts
(_PendingSegment) so concurrent transactions reuse term-dictionary and
stream buffers instead of reallocating them per batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")


class BoundedObjectPool(Generic[T]):
    """At most ``size`` live objects; ``acquire`` blocks when exhausted
    (reference: bounded_object_pool, object_pool.hpp:144)."""

    def __init__(self, factory: Callable[[], T], size: int) -> None:
        assert size >= 1
        self._factory = factory
        self._free: "queue.Queue[T]" = queue.Queue()
        self._sema = threading.Semaphore(size)

    def acquire(self, timeout: Optional[float] = None) -> Optional[T]:
        if not self._sema.acquire(timeout=timeout):
            return None
        try:
            return self._free.get_nowait()
        except queue.Empty:
            return self._factory()

    def release(self, obj: T) -> None:
        self._free.put(obj)
        self._sema.release()

    class _Lease:
        def __init__(self, pool, obj):
            self._pool, self.obj = pool, obj

        def __enter__(self):
            return self.obj

        def __exit__(self, *exc):
            self._pool.release(self.obj)

    def lease(self, timeout: Optional[float] = None) -> "_Lease":
        obj = self.acquire(timeout=timeout)
        if obj is None:
            raise TimeoutError("object pool exhausted")
        return self._Lease(self, obj)


class UnboundedObjectPool(Generic[T]):
    """Keeps up to ``max_cached`` idle objects; never blocks
    (reference: unbounded_object_pool, object_pool.hpp:379)."""

    def __init__(self, factory: Callable[[], T], max_cached: int = 16) -> None:
        self._factory = factory
        self._max = max_cached
        self._free: List[T] = []
        self._mutex = threading.Lock()

    def acquire(self) -> T:
        with self._mutex:
            if self._free:
                return self._free.pop()
        return self._factory()

    def release(self, obj: T) -> None:
        with self._mutex:
            if len(self._free) < self._max:
                self._free.append(obj)


class WaitGroup:
    """Go-style wait group (reference: core/utils/wait_group.hpp)."""

    def __init__(self) -> None:
        self._count = 0
        self._cond = threading.Condition()

    def add(self, n: int = 1) -> None:
        with self._cond:
            self._count += n

    def done(self) -> None:
        with self._cond:
            self._count -= 1
            if self._count <= 0:
                self._cond.notify_all()

    def wait(self, timeout: Optional[float] = None) -> bool:
        with self._cond:
            return self._cond.wait_for(lambda: self._count <= 0, timeout)


class ThreadPool:
    """Fixed pool with named threads (reference: async_utils::ThreadPool,
    async_utils.hpp:54). ``submit`` enqueues a callable; ``stop`` drains
    (run_pending=True) or abandons queued work."""

    def __init__(self, threads: int, name: str = "irs") -> None:
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(
                target=self._run, name=f"{name}-{i}", daemon=True
            )
            for i in range(max(1, threads))
        ]
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, wg = item
            try:
                fn()
            finally:
                if wg is not None:
                    wg.done()

    def submit(self, fn: Callable[[], None], wg: Optional[WaitGroup] = None):
        if self._stop.is_set():
            raise RuntimeError("pool stopped")
        if wg is not None:
            wg.add(1)
        self._q.put((fn, wg))

    def stop(self, run_pending: bool = True) -> None:
        self._stop.set()
        if not run_pending:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join()
