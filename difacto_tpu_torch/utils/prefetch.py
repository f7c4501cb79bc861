"""Background prefetch iterator.

Counterpart of the reference's dmlc-core ``threadediter.h`` :: ThreadedIter
(producer/consumer prefetch of parsed chunks) and the prefetch thread of
``src/data/data_store.h``. Host-side parsing/padding overlaps with device
compute; depth > 1 keeps the device fed across parse-time jitter.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_END = object()


class ThreadedIter(Iterator[T]):
    def __init__(self, source: Iterable[T], depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None

        def run():
            try:
                for item in source:
                    self._q.put(item)
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                self._q.put(_END)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self) -> T:
        item = self._q.get()
        if item is _END:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class MappedPrefetchIter(Iterator):
    """Order-preserving parallel ``map`` over a producer iterator.

    The transform stage (batch padding + np.unique localization) is the
    host-side hot path; NumPy sort/unique release the GIL, so a small
    thread pool scales it. Items are submitted ``depth`` ahead and
    yielded in order — the reference's bounded in-flight minibatch queue
    (AsyncLocalTracker) with workers, minus the staleness.
    """

    def __init__(self, source: Iterable, fn, workers: int = 2, depth: int = 6):
        import concurrent.futures as cf

        self._pool = cf.ThreadPoolExecutor(max_workers=max(workers, 1))
        self._src = iter(source)
        self._fn = fn
        self._depth = max(depth, 1)
        self._pending: queue.Queue = queue.Queue()
        self._done_submitting = False
        self._fill()

    def _fill(self) -> None:
        while not self._done_submitting and self._pending.qsize() < self._depth:
            try:
                item = next(self._src)
            except StopIteration:
                self._done_submitting = True
                self._pool.shutdown(wait=False)
                return
            self._pending.put(self._pool.submit(self._fn, item))

    def __iter__(self):
        return self

    def __next__(self):
        if self._pending.empty():
            raise StopIteration
        fut = self._pending.get()
        self._fill()
        return fut.result()
