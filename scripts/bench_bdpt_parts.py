#!/usr/bin/env python
"""Attribute the BDPT pass cost to its stages on the real chip.

Times (each as its own jit, median of reps): the eye walk, the light walk,
and each connection-case group's strategy scan (s0 / t1 / s1 / gen) given
pre-built subpath buffers. Numbers guide the VERDICT r2 #5 cost cut
(cbox 6-bounce was 147 ms/pass; target <= 60).

Run: python scripts/bench_bdpt_parts.py      (SCENE/BOUNCES env as usual)
"""
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from adapt_tpu.utils.runtime import setup_compile_cache
setup_compile_cache()


def timeit(fn, *args, reps=5, warmup=2):
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def main():
    from adapt_tpu.scene.compile import load_scene
    from adapt_tpu.renderer import bdpt as B

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene, cfg, _ = load_scene(os.path.join(here, "scenes", "cbox"),
                               os.environ.get("SCENE", "cbox.xml"))
    cfg = dataclasses.replace(cfg, max_bounce=int(
        os.environ.get("BOUNCES", "6")))
    max_bnc = min(cfg.max_bounce, B.CAP)
    N = cfg.n_pixels
    key = jax.random.PRNGKey(0)

    eye = jax.jit(lambda k: B.generate_eye_path(scene, cfg, k, jnp.int32(1),
                                                max_bnc))
    lit = jax.jit(lambda k: B.generate_light_path(scene, cfg, k, max_bnc,
                                                  n_paths=N))
    print(f"eye walk:   {timeit(eye, key) * 1e3:8.1f} ms")
    print(f"light walk: {timeit(lit, key) * 1e3:8.1f} ms")

    cam_buf, cam_vnum = jax.block_until_ready(eye(key))
    lit_buf, lit_vnum = jax.block_until_ready(lit(jax.random.fold_in(key, 1)))

    t_hi = min(cfg.end_t - 1, max_bnc + 1)
    s_hi = min(cfg.end_s - 1, max_bnc + 1)
    groups = {"s0": [], "t1": [], "s1": [], "gen": []}
    k_idx = 0
    for t in range(max(cfg.start_t, 1), t_hi + 1):
        for s in range(max(cfg.start_s, 0), s_hi + 1):
            depth = s + t - 2
            if (s == 1 and t == 1) or depth < 0 or depth > cfg.max_bounce:
                continue
            k_idx += 1
            groups[B._strategy_case(s, t)].append((s, t, k_idx))

    for case, table in groups.items():
        if not table:
            continue

        def run(k, case=case, table=tuple(table)):
            def body(carry, row):
                radiance, raster, _pt, _wo = B.connect_strategy(
                    scene, cfg, jax.random.fold_in(k, row[2]),
                    cam_buf, cam_vnum, lit_buf, lit_vnum,
                    row[0], row[1], case=case)
                return carry + jnp.sum(radiance), raster
            acc, _ = jax.lax.scan(body, jnp.float32(0),
                                  jnp.asarray(table, jnp.int32))
            return acc
        dt = timeit(jax.jit(run), key)
        print(f"group {case:3s} ({len(table):2d} strategies): "
              f"{dt * 1e3:8.1f} ms   ({dt * 1e3 / len(table):5.1f} ms/strategy)")


if __name__ == "__main__":
    main()
