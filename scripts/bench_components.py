#!/usr/bin/env python
"""Time one closest-hit and one any-hit intersect call of 512^2 random
rays on each intersector a scene can take: the jnp chunk scan, the Pallas
triangle kernel (<= 256 prims) and the BVH walk (scenes with a BVH).

    python scripts/bench_components.py            # SCENE=cbox.xml
    SCENE=knot290k.xml python scripts/bench_components.py

Needs a CUDA card; prints one line per (intersector, query) in ms.
"""
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def timed(fn, reps=5):
    import jax
    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def main():
    import jax
    from adapt_tpu.utils.runtime import pin_platform, setup_compile_cache
    pin_platform("gpu")
    setup_compile_cache()
    import jax.numpy as jnp
    from adapt_tpu.scene.compile import load_scene, SMALL_SCENE_PRIMS
    from adapt_tpu.ops.intersect import ray_intersect, does_intersect

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene, cfg, _ = load_scene(os.path.join(here, "scenes", "cbox"),
                               os.environ.get("SCENE", "cbox.xml"))
    N = 512 * 512
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    lo = jnp.min(scene.obj_aabb_min, axis=0)
    hi = jnp.max(scene.obj_aabb_max, axis=0)
    o = jax.random.uniform(k1, (N, 3)) * (hi - lo) + lo
    d = jax.random.normal(k2, (N, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    max_t = jnp.full((N,), 1.0, jnp.float32)

    P = int(scene.prim_ng.shape[0])
    tiers = {}
    if P <= SMALL_SCENE_PRIMS:
        tiers["scan"] = dict(use_bvh=False, use_pallas=False)
        if scene.tri_n.shape[0] > 0:
            tiers["pallas"] = dict(use_bvh=False, use_pallas=True)
    if scene.bvh_node_pack.shape[0] > 1:
        tiers["bvh"] = dict(use_bvh=True, use_pallas=False)
    print(f"{P} prims, {N} rays, device {jax.devices()[0].device_kind}",
          flush=True)
    for name, over in tiers.items():
        c = dataclasses.replace(cfg, **over)
        closest = jax.jit(lambda o, d: ray_intersect(scene, c, o, d).t)
        anyhit = jax.jit(lambda o, d: does_intersect(scene, c, o, d, max_t))
        print(f"{name:6s} closest {timed(lambda: closest(o, d)) * 1e3:8.3f}"
              f" ms  any {timed(lambda: anyhit(o, d)) * 1e3:8.3f} ms",
              flush=True)


if __name__ == "__main__":
    main()
