#!/usr/bin/env python
"""Attribute BDPT connection cost: time the full pass with individual
connect components stubbed out (timing only — stubbed variants return
wrong radiance by construction).

Variants: base, no_mis (cfg.use_mis=False), no_vis (track_ray -> ones),
no_eval (eval_vertex -> constant). Deltas vs base attribute the ~70
ms/pass the strategy groups cost on cbox 6-bounce after the fused-walk
change. Env: SCENE (cbox.xml), BOUNCES (6), REPS (5).
"""
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    import jax
    from adapt_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    import jax.numpy as jnp
    from adapt_tpu.scene.compile import load_scene
    from adapt_tpu.renderer import bdpt as B

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene, cfg, _ = load_scene(os.path.join(here, "scenes", "cbox"),
                               os.environ.get("SCENE", "cbox.xml"))
    cfg = dataclasses.replace(cfg, max_bounce=int(
        os.environ.get("BOUNCES", "6")))
    reps = int(os.environ.get("REPS", "5"))
    key = jax.random.PRNGKey(0)

    def timed(fn):
        """Median wall time; fn returns a scalar reduced inside the jit,
        and block_until_ready ends each call."""
        jax.block_until_ready(fn(key, jnp.int32(1)))
        ts = []
        for r in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(jax.random.fold_in(key, r),
                                     jnp.int32(r + 2)))
            ts.append(time.perf_counter() - t0)
        ts.sort()
        return ts[len(ts) // 2]

    # a FRESH jit wrapper per variant around the unjitted pass body —
    # the module-level render_pass_bdpt is itself jitted with static cfg
    # and would serve its cached executable to the monkeypatched variants
    unjitted = B.render_pass_bdpt.__wrapped__

    def run_variant(name, cfg_v):
        fn = jax.jit(lambda k, c: jnp.sum(unjitted(scene, cfg_v, k, c)[0]))
        dt = timed(fn)
        print(f"{name:10s}: {dt * 1e3:7.1f} ms", flush=True)
        return dt

    base = run_variant("base", cfg)
    run_variant("no_mis", dataclasses.replace(cfg, use_mis=False))

    real_track = B.track_ray
    real_eval = B.eval_vertex
    try:
        B.track_ray = lambda scene, cfg, o, d, depth, key=None, thp=None, \
            active=None: (jnp.ones(o.shape[:1] + (3,), jnp.float32),
                          depth)
        run_variant("no_vis", cfg)
    finally:
        B.track_ray = real_track
    try:
        B.eval_vertex = lambda scene, cfg, v, d, mode: \
            jnp.full(v["pos"].shape, 0.1, jnp.float32)
        run_variant("no_eval", cfg)
    finally:
        B.eval_vertex = real_eval
    print(f"base = {base * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
