"""Streamed (per-frame) serving with bounded in-flight depth.

For a stream of single frames (a camera callback) the dispatch shape is
a sequence of per-frame calls with a few in flight: JAX's asynchronous
dispatch lets the host enqueue frame i+1 while the device works on
frame i.  This module adds the bounded depth (backpressure) and the
ordering a serving loop needs.

The reference has no serving layer (its closest analogue is the adb
run loop, run.sh:96-104).
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator

import jax


def stream_map(fn: Callable, frames: Iterable, depth: int = 4) -> Iterator:
    """Yield ``fn(frame)`` for each frame, keeping up to ``depth``
    device computations in flight.

    ``fn`` is jit-compiled once; results are yielded in submission
    order as (still-async) device arrays — call ``np.asarray`` /
    ``jax.device_get`` on a yielded value to block on just that frame.
    ``depth`` bounds device-memory growth (backpressure): each yield
    hands back the OLDEST computation, which the consumer's readback
    naturally rate-limits.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    fnj = jax.jit(fn)
    q: deque = deque()
    for f in frames:
        q.append(fnj(f))
        if len(q) >= depth:
            yield q.popleft()
    while q:
        yield q.popleft()


class StreamExecutor:
    """Submit/poll interface over :func:`stream_map`'s discipline, for
    push-style sources (e.g. a camera callback).

    ``submit`` dispatches asynchronously and returns the oldest
    in-flight result once ``depth`` are pending (the same bound
    :func:`stream_map` keeps), else None; ``drain`` yields the rest.
    """

    def __init__(self, fn: Callable, depth: int = 4):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._fn = jax.jit(fn)
        self._depth = depth
        self._q: deque = deque()

    def submit(self, frame):
        self._q.append(self._fn(frame))
        if len(self._q) >= self._depth:  # same discipline as stream_map
            return self._q.popleft()
        return None

    def drain(self):
        while self._q:
            yield self._q.popleft()
