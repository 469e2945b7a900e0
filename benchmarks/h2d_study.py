"""Host→device transfer study — the successor of the reference's
``cuda.md`` memory-management micro-benchmarks (malloc vs pinned vs
zero-copy, cuda.md:1-30).

In JAX the host-side staging strategies collapse into ``device_put``
variants; what remains worth measuring per machine:

1. ``device_put`` throughput vs buffer size (the H2D memcpy analogue);
2. device→host fetch throughput (the D2H path).

Exits non-zero without a GPU.

Run: python -m benchmarks.h2d_study
"""
from __future__ import annotations

import json
import time

import numpy as np


def _bw(nbytes, sec):
    return nbytes / sec / 1e9


def run():
    import jax

    from vacv_tpu.utils.perf import card_info, require_gpu

    require_gpu(jax.devices())
    dev = jax.devices()[0]
    results = {"platform": dev.platform, "kind": dev.device_kind,
               "count": len(jax.devices()), "card": card_info()}
    rows = []
    for mb in (1, 16, 64, 256):
        x = np.random.default_rng(0).integers(
            0, 256, size=(mb * 1024 * 1024,), dtype=np.uint8
        )
        # H2D
        jax.block_until_ready(jax.device_put(x[: 1024]))  # warm path
        t0 = time.perf_counter()
        d = jax.block_until_ready(jax.device_put(x))
        h2d = time.perf_counter() - t0
        # D2H
        t0 = time.perf_counter()
        _ = np.asarray(d)
        d2h = time.perf_counter() - t0
        rows.append({
            "size_mb": mb,
            "h2d_gbps": round(_bw(x.nbytes, h2d), 3),
            "d2h_gbps": round(_bw(x.nbytes, d2h), 3),
        })
        print(f"{mb:4d} MB  h2d {rows[-1]['h2d_gbps']:8.3f} GB/s   "
              f"d2h {rows[-1]['d2h_gbps']:8.3f} GB/s")
    results["transfers"] = rows
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    run()
