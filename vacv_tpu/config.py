"""Runtime configuration: the persistent compile cache and trace-time
route counters.

The reference selects kernels at compile time via CMake flags
(``USE_NEON`` / ``USE_CUDA`` / ``USE_OPENCV``, reference
``CMakeLists.txt:8-18``).  Here every op has one route, plain
``jax.numpy`` / ``lax`` compiled by XLA for whatever device JAX finds.
"""
from __future__ import annotations

import os

import jax

# Cache location when JAX_COMPILATION_CACHE_DIR is unset: a fixed path
# inside the checkout (listed in .gitignore), so the cache key's path
# component is stable from one run to the next.
_DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path.

    ``$JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself,
    so nothing is overridden); otherwise the cache lives in
    ``<checkout>/.jax_cache``.  Benchmark CLIs and ``chip_smoke.py``
    call this so repeated runs on one machine reuse compiled programs.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = _DEFAULT_CACHE
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path


# --- route observability ------------------------------------------
# Trace-time counters recording which route served an op, for routes
# chosen from the operands (``warp_separable``: the banded-matmul warp
# for axis-aligned matrices).  ``record_kernel`` is called at trace
# time; tests read ``kernel_count``.
_KERNEL_COUNTS: dict[str, int] = {}


def record_kernel(name: str) -> None:
    _KERNEL_COUNTS[name] = _KERNEL_COUNTS.get(name, 0) + 1


def kernel_count(name: str) -> int:
    return _KERNEL_COUNTS.get(name, 0)
