#!/usr/bin/env python
"""Time wavefront sort variants on the real chip.

The cluster-tier intersect sorts rays by a coherence key with ONE
multi-operand lax.sort (ops/intersect.py _sort_by). The component bench
measured the 9-operand forward sort at ~240 ms per 512^2 call — more
than the intersection kernel itself — so this sweeps the design space:
operand count, and global vs segmented (axis-1) sorts.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def timed(fn, reps=5):
    import numpy as np
    import jax
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        float(np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[0])
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def main():
    import jax
    from adapt_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    N = 512 * 512
    k = jax.random.PRNGKey(0)
    key = jax.random.randint(jax.random.fold_in(k, 1), (N,), 0, 1613 * 8)
    cols = [jax.random.normal(jax.random.fold_in(k, 10 + i), (N,))
            for i in range(8)]

    def multi(n_payload):
        def f(key, *cs):
            return jax.lax.sort((key,) + cs, dimension=0, num_keys=1)[1]
        return jax.jit(f), cols[:n_payload]

    for npay in (1, 2, 4, 8):
        f, cs = multi(npay)
        np.asarray(f(key, *cs))
        print(f"global {npay+1}-op : {timed(lambda: f(key, *cs))*1e3:7.1f} ms",
              flush=True)

    for seg in (2048, 8192, 32768):
        S = N // seg

        def fseg(key, *cs, S=S, seg=seg):
            ops = tuple(x.reshape(S, seg) for x in (key,) + cs)
            return jax.lax.sort(ops, dimension=1, num_keys=1)[1]
        f = jax.jit(fseg)
        np.asarray(f(key, *cols))
        print(f"seg{seg:6d} 9-op: {timed(lambda: f(key, *cols))*1e3:7.1f} ms",
              flush=True)

    # sort_key_val-style i32 payload (packed) vs f32
    def fpack(key, idx):
        return jax.lax.sort((key, idx), dimension=0, num_keys=1)[1]
    fp = jax.jit(fpack)
    idx = jnp.arange(N, dtype=jnp.int32)
    np.asarray(fp(key, idx))
    print(f"global key+idx : {timed(lambda: fp(key, idx))*1e3:7.1f} ms",
          flush=True)


if __name__ == "__main__":
    main()
