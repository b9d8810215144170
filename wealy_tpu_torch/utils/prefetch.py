"""Background-thread prefetching for the host -> device input pipeline, the
counterpart of ``wealy_tpu.utils.prefetch``: one worker thread keeps
``depth`` items collated (and placed, by ``transform``) ahead of the
consumer. A plain ``.to(device)`` in ``transform`` is the placement; pinned
memory and copy streams are later work.
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
    is raised to the consumer at the item where it happened; leaving the
    loop early cancels the items not yet started."""
    source = iter(iterable)

    def produce():
        item = next(source, _DONE)
        if item is _DONE or transform is None:
            return item
        return transform(item)

    with contextlib.ExitStack() as stack:
        pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="prefetch")
        stack.callback(pool.shutdown, wait=False, cancel_futures=True)
        pending = collections.deque(pool.submit(produce) for _ in range(max(1, depth)))
        while True:
            item = pending.popleft().result()
            if item is _DONE:
                return
            pending.append(pool.submit(produce))
            yield item
