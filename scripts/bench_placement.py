"""Measure the three placement primitives that decide executor tiers.

The executor must place decoded (doc, score) lanes somewhere a
tree fold can combine them. The candidates are:
  scatter  — leaf_score.at[docs].add(sc) into a [nd] grid
  sort     — lax.sort((docs, sc, pay), num_keys=1) + segmented scan
  gather   — random sc[docs] reads (probe direction)
  stream   — sequential elementwise over [nd] (the dense-term path)
This prints ns/lane for each at several sizes on the device, so tier
thresholds in exec/plan.py are set from measurements, not folklore.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def timeit(fn, *args, reps=10):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        r = fn(*args)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / reps


def main():
    from iresearch_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    nd = 5_242_880
    rng = np.random.default_rng(0)
    print(f"devices: {jax.devices()}")

    for p in (100_000, 1_000_000, 8_000_000):
        docs = jnp.asarray(
            np.sort(rng.choice(nd, size=p).astype(np.int32))
        )
        sc = jnp.asarray(rng.random(p).astype(np.float32))
        pay = jnp.asarray(rng.integers(0, 8, p).astype(np.int32))
        grid = jnp.zeros(nd, jnp.float32)

        scatter = jax.jit(
            lambda g, d, s: g.at[d].add(s, mode="drop")
        )
        t = timeit(scatter, grid, docs, sc)
        print(f"P={p:>9,}: scatter-add [nd grid]   {t*1e9/p:8.2f} ns/lane  ({t*1e3:.2f} ms)")

        sort3 = jax.jit(
            lambda d, s, q: lax.sort((d, s, q), num_keys=1)
        )
        t = timeit(sort3, docs, sc, pay)
        print(f"P={p:>9,}: sort 3-operand          {t*1e9/p:8.2f} ns/lane  ({t*1e3:.2f} ms)")

        sort2 = jax.jit(lambda d, s: lax.sort((d, s), num_keys=1))
        t = timeit(sort2, docs, sc)
        print(f"P={p:>9,}: sort 2-operand          {t*1e9/p:8.2f} ns/lane  ({t*1e3:.2f} ms)")

        big = jnp.asarray(rng.random(nd).astype(np.float32))
        gather = jax.jit(lambda b, d: b[d])
        t = timeit(gather, big, docs)
        print(f"P={p:>9,}: random gather           {t*1e9/p:8.2f} ns/lane  ({t*1e3:.2f} ms)")

        # searchsorted scan-mode: P queries into a 1M-entry sorted table
        tab = jnp.asarray(np.sort(rng.choice(1 << 30, 1_000_000).astype(np.int32)))
        ss = jax.jit(lambda t_, d: jnp.searchsorted(t_, d, method="scan"))
        t = timeit(ss, tab, docs)
        print(f"P={p:>9,}: searchsorted(1M tbl)    {t*1e9/p:8.2f} ns/lane  ({t*1e3:.2f} ms)")

    # stream: elementwise score over the whole grid (dense-term path)
    freq = jnp.asarray(rng.integers(0, 15, nd).astype(np.float32))
    dl = jnp.asarray(rng.integers(32, 96, nd).astype(np.float32))
    stream = jax.jit(
        lambda f, d: jnp.where(f > 0, 1.2 * f / (f + 0.3 * d), 0.0)
    )
    t = timeit(stream, freq, dl)
    print(f"grid {nd:,}: stream score            {t*1e9/nd:8.2f} ns/lane  ({t*1e3:.2f} ms)")

    from iresearch_tpu.ops.topk import wide_top_k

    tk = jax.jit(lambda f: wide_top_k(f, 10))
    t = timeit(tk, freq)
    print(f"grid {nd:,}: wide_top_k k=10         {t*1e9/nd:8.2f} ns/lane  ({t*1e3:.2f} ms)")


if __name__ == "__main__":
    main()
