"""Benchmark: wavefront PT throughput on cornell-box 512^2, 8 bounces.

Prints ONE JSON line {"metric", "value", "unit", "device"}: the median of
BENCH_REPS timed dispatches of BENCH_ITERS samples each. Needs a CUDA card
(the platform is pinned; there is no CPU fallback).

Ray accounting: every pass casts, per pixel, 1 primary ray, num_shadow_ray
shadow rays per bounce, and max_bounce-1 continuation rays (the LAST
bounce's continuation intersect is skipped — its hit would feed nothing).
The wavefront executes all lanes each bounce, so this is also the true
computational ray count: count only rays actually cast.
"""
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    import jax
    from adapt_tpu.utils.runtime import pin_platform, setup_compile_cache
    pin_platform("gpu")
    setup_compile_cache()
    import jax.numpy as jnp
    from adapt_tpu.scene.compile import load_scene
    from adapt_tpu.renderer.pt import render_batch_pt

    here = os.path.dirname(os.path.abspath(__file__))
    scene, cfg, _ = load_scene(os.path.join(here, "scenes", "cbox"),
                               "cbox.xml")
    cfg = dataclasses.replace(cfg, max_bounce=8)

    key = jax.random.PRNGKey(0)
    iters = int(os.environ.get("BENCH_ITERS", "64"))
    fuse = int(os.environ.get("BENCH_FUSE", "1"))
    out = render_batch_pt(scene, cfg, key, jnp.int32(1), iters, fuse)
    jax.block_until_ready(out)

    reps = int(os.environ.get("BENCH_REPS", "5"))
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        out = render_batch_pt(scene, cfg, jax.random.fold_in(key, r + 1),
                              jnp.int32(iters + 1), iters, fuse)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    dt = times[len(times) // 2]

    rays_per_pass = cfg.n_pixels * (
        1 + cfg.max_bounce * cfg.num_shadow_ray + (cfg.max_bounce - 1))
    mrays = rays_per_pass * iters / dt / 1e6
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "pt_cbox512_throughput",
        "value": mrays,
        "unit": "Mrays/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
