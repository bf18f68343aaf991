"""Background host-batch prefetching for the training loop.

A copy of ``eventgpt_tpu/train/prefetch.py``. ``batch_iterator`` is a
plain synchronous generator, so without prefetch every optimizer step
would wait on host work: ``np.load``, the event rasterization and the CLIP
resize per sample. ``PrefetchIterator`` wraps any iterator with one
producer thread and a bounded queue: while the device runs step N, the host
prepares batches N+1..N+depth. Threads suffice because the heavy numpy work
releases the GIL.

Contract:
  * ordering preserved exactly;
  * producer exceptions re-raise in the consumer at the point of ``next()``
    with their original type and traceback;
  * ``close()`` (or GC / ``with`` exit) stops the producer promptly even if
    the queue is full, so the consumer never leaks a blocked thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, Optional

_SENTINEL = object()


class PrefetchIterator:
    """Iterate ``source`` with ``depth`` batches prepared ahead."""

    def __init__(self, source: Iterable[Any], depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._produce, args=(iter(source),), daemon=True,
            name="egpt-prefetch",
        )
        self._thread.start()

    def _put_until_stop(self, obj: Any) -> bool:
        """put() with a poll so a closed consumer unblocks the producer.
        Returns False when the stop flag fired before the put landed."""
        while not self._stop.is_set():
            try:
                self._queue.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, it: Iterator[Any]) -> None:
        try:
            for item in it:
                if not self._put_until_stop(item):
                    return
        except BaseException as e:  # re-raised in the consumer
            self._error = e
        finally:
            self._put_until_stop(_SENTINEL)

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self) -> Any:
        if self._stop.is_set():
            raise StopIteration
        item = self._queue.get()
        if item is _SENTINEL:
            self._stop.set()
            if self._error is not None:
                err = self._error
                self._error = None
                # Original type + traceback: the trainer must see the same
                # exception with prefetch on or off.
                raise err
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        # Drain so a blocked producer put() can observe the stop flag.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort; close() is the real API
        try:
            self._stop.set()
        except Exception:
            pass
