#!/usr/bin/env python
"""Measure t=1 splat-accumulation strategies on the chip.

BDPT's light-tracing strategies scatter-add (N,3) radiance into the full
(n_pixels,3) film; xprof shows each such scatter costs ~4.2 ms (18% of the
whole cbox 6-bounce pass across 6 strategies). Candidates:

  a. per-strategy scatter (status quo): S scatters of N rows
  b. batched scatter: ONE scatter of S*N rows after the strategy scan
  c. sort-by-index then scatter: does index locality help XLA's scatter?
  d. one f32 film per strategy, summed after (no scatter at all: each
     strategy writes its own film... still needs a scatter per strategy —
     skipped; included here only as the lower bound of S * elementwise-add)

Run on the chip: python scripts/bench_scatter.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax
import jax.numpy as jnp


def timeit(fn, *args, reps=5):
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def main():
    from adapt_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    N = 512 * 512
    S = 6
    P = N + 1                       # film + drop row
    key = jax.random.PRNGKey(0)
    # raster targets concentrated like real splats: ~70% valid, clustered
    idx = jax.random.randint(key, (S, N), 0, N)
    ok = jax.random.uniform(jax.random.fold_in(key, 1), (S, N)) < 0.7
    idx = jnp.where(ok, idx, N)
    rad = jax.random.uniform(jax.random.fold_in(key, 2), (S, N, 3))

    @jax.jit
    def per_strategy(idx, rad):
        film = jnp.zeros((P, 3), jnp.float32)

        def body(i, film):
            return film.at[idx[i]].add(rad[i], mode="drop")
        return jax.lax.fori_loop(0, S, body, film)

    @jax.jit
    def batched(idx, rad):
        film = jnp.zeros((P, 3), jnp.float32)
        return film.at[idx.reshape(-1)].add(rad.reshape(-1, 3), mode="drop")

    @jax.jit
    def sorted_batched(idx, rad):
        film = jnp.zeros((P, 3), jnp.float32)
        fi = idx.reshape(-1)
        fr = rad.reshape(-1, 3)
        fi, r0, r1, r2 = jax.lax.sort(
            [fi, fr[:, 0], fr[:, 1], fr[:, 2]], num_keys=1)
        return film.at[fi].add(jnp.stack([r0, r1, r2], -1), mode="drop")

    for name, fn in [("a per-strategy x6", per_strategy),
                     ("b one batched", batched),
                     ("c sort+scatter", sorted_batched)]:
        dt = timeit(fn, idx, rad)
        print(f"{name:20s} {dt * 1e3:8.2f} ms")


if __name__ == "__main__":
    main()
