"""Profile the grid-volume tracking cost on the real chip.

Times sample_distance_delta_tracking / eval_tr_ratio_tracking on rays from
the cbox-rgbvol scene (camera rays + shadow-ray-like bundles), and reports
the while-loop step distribution (how many iterations lanes actually need,
vs how many the all-lanes loop runs).

Run: python scripts/bench_volume.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from adapt_tpu.utils.runtime import setup_compile_cache
setup_compile_cache()


def fetch(x):
    return np.asarray(x)


def timeit(fn, *args, reps=5, warmup=2):
    for _ in range(warmup):
        fetch(jax.tree_util.tree_leaves(fn(*args))[0])
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fetch(jax.tree_util.tree_leaves(fn(*args))[0])
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def main():
    from adapt_tpu.scene.compile import load_scene
    from adapt_tpu.renderer.base import camera_rays
    from adapt_tpu.ops import volume_ops

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene, cfg, _ = load_scene(os.path.join(here, "scenes", "cbox"),
                               "cbox-rgbvol.xml")
    vol = scene.volume
    print("grid shape:", vol.grid.shape, "majorant:", fetch(vol.majorant),
          "aabb:", fetch(vol.mini), fetch(vol.maxi))

    N = cfg.n_pixels
    key = jax.random.PRNGKey(0)
    ray_o, ray_d = jax.jit(
        lambda k: camera_rays(scene, cfg, k, jnp.int32(1)))(key)
    thp = jnp.ones((N, 3), jnp.float32)
    max_t = jnp.full((N,), 1e7, jnp.float32)

    # how many lanes even cross the volume?
    near, far = jax.jit(volume_ops.intersect_volume)(vol, ray_o, ray_d,
                                                     max_t)
    crossing = fetch((near < far) & (far > 0.0))
    print(f"camera rays crossing volume: {crossing.mean()*100:.1f}%")
    exp_steps = fetch(jnp.where(crossing,
                                (far - near) * jnp.max(vol.majorant), 0.0))
    print(f"expected majorant steps (crossing lanes): "
          f"mean {exp_steps[crossing].mean():.1f} "
          f"p99 {np.percentile(exp_steps[crossing], 99):.1f} "
          f"max {exp_steps.max():.1f}")

    f_delta = jax.jit(lambda k, o, d, t, m: volume_ops
                      .sample_distance_delta_tracking(
                          vol, cfg.volume_kind, k, o, d, t, m))
    dt = timeit(f_delta, key, ray_o, ray_d, thp, max_t)
    print(f"delta tracking (camera rays, N={N}): {dt*1e3:9.2f} ms")

    f_ratio = jax.jit(lambda k, o, d, t, m: volume_ops
                      .eval_tr_ratio_tracking(
                          vol, cfg.volume_kind, k, o, d, t, m))
    dt = timeit(f_ratio, key, ray_o, ray_d, thp, max_t)
    print(f"ratio tracking (camera rays, N={N}): {dt*1e3:9.2f} ms")

    # incoherent bounce-like rays: random origins in the box, random dirs
    k1, k2 = jax.random.split(key)
    ro2 = jax.random.uniform(k1, (N, 3)) * 2.0 - 1.0
    ro2 = ro2 * jnp.array([2.7, 2.7, 2.7]) + jnp.array([0.0, 2.7, 0.0])
    rd2 = jax.random.normal(k2, (N, 3))
    rd2 = rd2 / jnp.linalg.norm(rd2, axis=-1, keepdims=True)
    dt = timeit(f_delta, key, ro2, rd2, thp, max_t)
    print(f"delta tracking (random rays, N={N}): {dt*1e3:9.2f} ms")
    dt = timeit(f_ratio, key, ro2, rd2, thp, max_t)
    print(f"ratio tracking (random rays, N={N}): {dt*1e3:9.2f} ms")


def render_bench():
    """Full-render s/spp for cbox-rgbvol at 512^2 (PARITY.md row)."""
    from adapt_tpu.scene.compile import load_scene
    from adapt_tpu.renderer.vpt import render_pass_vpt
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene, cfg, _ = load_scene(os.path.join(here, "scenes", "cbox"),
                               "cbox-rgbvol.xml")
    key = jax.random.PRNGKey(0)
    f = jax.jit(lambda k, c: render_pass_vpt(scene, cfg, k, c))
    dt = timeit(f, key, jnp.int32(1), reps=3, warmup=1)
    print(f"cbox-rgbvol 512^2 full render: {dt:8.3f} s/spp "
          f"(max_bounce={cfg.max_bounce})")




def ablate_bench():
    """Attribute tracking cost (ABLATE=1): const-density stub vs base on
    delta + ratio tracking, camera and random rays. The stub removes the
    per-lane grid gathers (timing only - results are wrong)."""
    from adapt_tpu.scene.compile import load_scene
    from adapt_tpu.renderer.base import camera_rays
    from adapt_tpu.ops import volume_ops

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene, cfg, _ = load_scene(os.path.join(here, "scenes", "cbox"),
                               "cbox-rgbvol.xml")
    vol = scene.volume
    N = cfg.n_pixels
    key = jax.random.PRNGKey(0)
    ray_o, ray_d = jax.jit(
        lambda k: camera_rays(scene, cfg, k, jnp.int32(1)))(key)
    thp = jnp.ones((N, 3), jnp.float32)
    max_t = jnp.full((N,), 1e7, jnp.float32)
    for mode in (None, "const_density"):
        volume_ops._ABLATE = mode
        f_delta = jax.jit(lambda k, o, d, t, m: volume_ops
                          .sample_distance_delta_tracking(
                              vol, cfg.volume_kind, k, o, d, t, m))
        dt = timeit(f_delta, key, ray_o, ray_d, thp, max_t)
        f_ratio = jax.jit(lambda k, o, d, t, m: volume_ops
                          .eval_tr_ratio_tracking(
                              vol, cfg.volume_kind, k, o, d, t, m))
        dr = timeit(f_ratio, key, ray_o, ray_d, thp, max_t)
        print(f"[{mode or 'base':14s}] delta {dt*1e3:8.2f} ms   "
              f"ratio {dr*1e3:8.2f} ms", flush=True)
    volume_ops._ABLATE = None


if __name__ == "__main__":
    if os.environ.get("ABLATE"):
        ablate_bench()
    elif os.environ.get("RENDER"):
        render_bench()
    else:
        main()
