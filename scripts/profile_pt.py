#!/usr/bin/env python
"""Profile one PT bench dispatch on the GPU and print top device ops.

Usage:

    PROTOCOL_BUFFERS_PYTHON_IMPLEMENTATION=python python scripts/profile_pt.py

Env knobs: BENCH_ITERS (spp per dispatch, default 32), BENCH_FUSE (default 4).
Traces with jax.profiler into /tmp/jaxtrace, then converts the xplane with
the xprof/tensorboard converter and prints the top rows of
'framework_op_stats' sorted by total self time.
"""
import dataclasses
import glob
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

TRACE_DIR = "/tmp/jaxtrace"


def main():
    import jax
    from adapt_tpu.utils.runtime import setup_compile_cache
    setup_compile_cache()
    import jax.numpy as jnp
    from adapt_tpu.scene.compile import load_scene
    from adapt_tpu.renderer.pt import render_batch_pt

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene, cfg, _ = load_scene(os.path.join(here, "scenes", "cbox"),
                               os.environ.get("SCENE", "cbox.xml"))
    cfg = dataclasses.replace(cfg, max_bounce=int(
        os.environ.get("BOUNCES", "8")))
    iters = int(os.environ.get("BENCH_ITERS", "32"))
    fuse = int(os.environ.get("BENCH_FUSE", "4"))
    key = jax.random.PRNGKey(0)

    # warmup/compile outside the trace
    jax.block_until_ready(render_batch_pt(scene, cfg, key, jnp.int32(1),
                                          iters, fuse))
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with jax.profiler.trace(TRACE_DIR):
        jax.block_until_ready(render_batch_pt(
            scene, cfg, jax.random.fold_in(key, 1), jnp.int32(iters + 1),
            iters, fuse))

    print(dump_op_stats())


def dump_op_stats(top=30):
    """Convert the captured xplane to framework_op_stats (gviz JSON) and
    format the top device ops by total self time."""
    import json
    from xprof.convert import raw_to_tool_data as rtd
    xs = glob.glob(TRACE_DIR + "/**/*.xplane.pb", recursive=True)
    data, _ = rtd.xspace_to_tool_data(xs, "framework_op_stats", {})
    if isinstance(data, bytes):
        data = data.decode()
    j = json.loads(data)
    tbl = j[0] if isinstance(j, list) else j
    cols = [c["id"] for c in tbl["cols"]]
    rows = [[c["v"] if c else None for c in r["c"]] for r in tbl["rows"]]
    i_hd = cols.index("host_or_device")
    i_ty = cols.index("type")
    i_op = cols.index("operation")
    i_st = cols.index("total_self_time")
    i_bb = cols.index("bound_by")
    i_oc = cols.index("occurrences")
    dev = sorted((r for r in rows if r[i_hd] == "Device"),
                 key=lambda r: -r[i_st])
    total = sum(r[i_st] for r in dev)
    out = [f"{'self_ms':>9} {'pct':>6} {'occ':>5}  {'bound':>8}  type :: op"]
    for r in dev[:top]:
        out.append(f"{r[i_st] / 1e3:9.2f} {100 * r[i_st] / total:5.1f}% "
                   f"{int(r[i_oc]):5d}  {str(r[i_bb]):>8}  "
                   f"{r[i_ty]} :: {r[i_op][-70:]}")
    out.append(f"device total self time: {total / 1e3:.2f} ms")
    return "\n".join(out)


if __name__ == "__main__":
    main()
