#!/usr/bin/env python
"""Profile ONE ratio-tracking (and delta-tracking) call on the GPU.

The r4 ablation (ABLATE=1 scripts/bench_volume.py) shows ratio tracking
is march-bound (167 ms base vs 157 ms with density gathers stubbed), but
a first-principles model (steps x gathers + vector ops) predicts ~15 ms
— this prints the op-level breakdown to find the real sink.

Usage:
    PROTOCOL_BUFFERS_PYTHON_IMPLEMENTATION=python \
        python scripts/profile_volume.py
"""
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from profile_pt import dump_op_stats, TRACE_DIR  # noqa: E402


def main():
    import jax
    from adapt_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    import jax.numpy as jnp
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

    which = os.environ.get("WHICH", "ratio")
    if which == "ratio":
        f = jax.jit(lambda k, o, d, t, m: volume_ops.eval_tr_ratio_tracking(
            vol, cfg.volume_kind, k, o, d, t, m))
    else:
        f = jax.jit(lambda k, o, d, t, m: volume_ops
                    .sample_distance_delta_tracking(
                        vol, cfg.volume_kind, k, o, d, t, m))
    jax.block_until_ready(f(key, ray_o, ray_d, thp, max_t))
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with jax.profiler.trace(TRACE_DIR):
        # several calls so per-call noise averages out
        for i in range(4):
            jax.block_until_ready(f(jax.random.fold_in(key, i), ray_o,
                                    ray_d, thp, max_t))
    print(f"({which} tracking, 4 calls; divide by 4)")
    print(dump_op_stats())


if __name__ == "__main__":
    main()
