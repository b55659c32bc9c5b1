#!/usr/bin/env python
"""Profile one VPT bench dispatch on the GPU and print top device ops.

Attribution for VERDICT r4 task #6: where do 83 ms/spp go on the
homogeneous-medium cbox at 16 bounces? Usage:

    PROTOCOL_BUFFERS_PYTHON_IMPLEMENTATION=python python scripts/profile_vpt.py

Env: SCENE (default vpt/cbox.xml), BOUNCES (16), BENCH_ITERS (8 spp).
"""
import dataclasses
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
    from adapt_tpu.renderer.vpt import render_batch_vpt

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    folder, xml = os.path.split(os.environ.get("SCENE", "vpt/cbox.xml"))
    scene, cfg, _ = load_scene(os.path.join(here, "scenes", folder), xml)
    cfg = dataclasses.replace(cfg, max_bounce=int(
        os.environ.get("BOUNCES", "16")))
    iters = int(os.environ.get("BENCH_ITERS", "8"))
    key = jax.random.PRNGKey(0)

    jax.block_until_ready(render_batch_vpt(scene, cfg, key, jnp.int32(1),
                                           iters, 1))
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with jax.profiler.trace(TRACE_DIR):
        jax.block_until_ready(render_batch_vpt(
            scene, cfg, jax.random.fold_in(key, 1), jnp.int32(iters + 1),
            iters, 1))

    print(f"({iters} spp dispatch; divide by {iters} for per-spp)")
    print(dump_op_stats())


if __name__ == "__main__":
    main()
