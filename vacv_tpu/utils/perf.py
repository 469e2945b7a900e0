"""Wall-clock timing utilities.

Parity with ``AutoPerf`` / ``TIME_PERF`` (reference
``/root/reference/src/util/perf_util.h:7-17``): a scope timer that
writes elapsed milliseconds into a caller-provided slot.  JAX dispatch
is asynchronous, so correct timing must block on device results —
``time_fn`` synchronizes via ``jax.block_until_ready``.
"""
from __future__ import annotations

import subprocess
import time
from contextlib import contextmanager

import jax


@contextmanager
def profiler_trace(logdir: str):
    """JAX profiler trace scope (SURVEY §5.1: the rebuild's
    deep-tracing mechanism, succeeding the reference's ``cudaEvent``
    instrumentation).  View with TensorBoard or xprof:

        with profiler_trace("/tmp/vacv-trace"):
            out = pipeline(batch)
            jax.block_until_ready(out)
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Accumulating wall-clock timer (milliseconds)."""

    def __init__(self) -> None:
        self.ms = 0.0

    @contextmanager
    def scope(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.ms += (time.perf_counter() - t0) * 1e3


@contextmanager
def time_perf(out: dict, key: str = "ms"):
    """``TIME_PERF``-style scope: writes elapsed ms into ``out[key]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        out[key] = (time.perf_counter() - t0) * 1e3


@contextmanager
def count_traces():
    """Count the jaxpr traces (new programs) started inside the scope.

    Yields a list that receives one entry per trace; a call served by an
    already-compiled program adds none.
    """
    traces: list[str] = []

    def listener(name, *_args, **_kwargs):
        if name == "/jax/core/compile/jaxpr_trace_duration":
            traces.append(name)

    jax.monitoring.register_event_duration_secs_listener(listener)
    try:
        yield traces
    finally:
        jax.monitoring.unregister_event_duration_listener(listener)


def time_fn(fn, *args, iters: int = 10, warmup: int = 2):
    """Time ``fn(*args)`` with device synchronization.

    Returns ``(best_ms, mean_ms, last_result)``.  Warm-up iterations
    absorb jit compilation (the reference's first-call cost is malloc;
    ours is XLA compilation — excluded the same way the reference
    averages over 10 repetitions, cv_profile.cpp:14).
    """
    result = None
    for _ in range(warmup):
        result = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        result = jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times), sum(times) / len(times), result


def require_gpu(devices) -> None:
    """Refuse to measure anywhere but on a GPU: a benchmark that falls
    back to the CPU would report the wrong device's numbers."""
    platform = devices[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"this measurement needs a GPU; JAX's default device is "
            f"{platform}")


def card_info() -> str:
    """The cards' names and power limits as ``nvidia-smi`` reports them
    (one line per card, joined with ``; ``)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(res.stdout.strip().splitlines())
