"""Background-thread prefetching for the host -> device input pipeline, the
counterpart of ``wealy_tpu.utils.prefetch``: one worker thread keeps
``depth`` items collated (and placed, by ``transform``) ahead of the
consumer. The split jobs' ``transform`` pads each batch into a page-locked
host buffer, which the device call uploads without blocking the host
(``cli/extract_batched.py``).
"""

from __future__ import annotations

import collections
import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

_DONE = object()


def prefetch(
    iterable: Iterable,
    depth: int = 2,
    transform: Optional[Callable] = None,
) -> Iterator:
    """Iterate ``iterable`` on a background thread, ``depth`` items ahead,
    in order. ``transform`` runs on that thread. An exception of the worker
    is raised to the consumer at the item where it happened. Closing the
    iterator (leaving the loop early) cancels the items not yet started,
    waits for the one running and then closes ``iterable`` where it has a
    ``close``: no thread of the prefetch outlives the close."""
    source = iter(iterable)

    def produce():
        item = next(source, _DONE)
        if item is _DONE or transform is None:
            return item
        return transform(item)

    with contextlib.ExitStack() as stack:
        if hasattr(source, "close"):
            stack.callback(source.close)  # after the worker has stopped: it runs the source
        pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="prefetch")
        stack.callback(pool.shutdown, wait=True, cancel_futures=True)
        pending = collections.deque(pool.submit(produce) for _ in range(max(1, depth)))
        while True:
            item = pending.popleft().result()
            if item is _DONE:
                return
            pending.append(pool.submit(produce))
            yield item
