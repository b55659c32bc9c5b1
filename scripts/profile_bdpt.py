#!/usr/bin/env python
"""Profile one BDPT pass on the GPU and print top device ops.

Usage: PROTOCOL_BUFFERS_PYTHON_IMPLEMENTATION=python \
    python scripts/profile_bdpt.py

Env: SCENE (default cbox.xml), BOUNCES (default 6), PASSES (default 4).
Also prints wall time per pass (median) so throughput deltas are
measurable without the separate bench_all run.
"""
import dataclasses
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from profile_pt import dump_op_stats, TRACE_DIR  # noqa: E402


def main():
    import jax
    from adapt_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    import jax.numpy as jnp
    from adapt_tpu.scene.compile import load_scene
    from adapt_tpu.renderer.bdpt import render_pass_bdpt

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene, cfg, _ = load_scene(os.path.join(here, "scenes", "cbox"),
                               os.environ.get("SCENE", "cbox.xml"))
    cfg = dataclasses.replace(cfg, max_bounce=int(
        os.environ.get("BOUNCES", "6")))
    passes = int(os.environ.get("PASSES", "4"))
    key = jax.random.PRNGKey(0)

    out = render_pass_bdpt(scene, cfg, key, jnp.int32(1))
    jax.block_until_ready(out)

    times = []
    for r in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(render_pass_bdpt(
            scene, cfg, jax.random.fold_in(key, r), jnp.int32(r + 2)))
        times.append(time.perf_counter() - t0)
    times.sort()
    print(f"median pass wall: {times[2] * 1e3:.1f} ms")

    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with jax.profiler.trace(TRACE_DIR):
        for r in range(passes):
            jax.block_until_ready(render_pass_bdpt(
                scene, cfg, jax.random.fold_in(key, 100 + r),
                jnp.int32(100 + r)))

    print(dump_op_stats())


if __name__ == "__main__":
    main()
