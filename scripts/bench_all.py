#!/usr/bin/env python
"""Secondary benchmark rows on the GPU (bench.py is the PT headline):

    vpt_cbox512_ms_per_spp      homogeneous-medium cbox, 16 bounces
    bdpt_cbox512_ms_per_spp     cbox BDPT, 6 bounces
    rgbvol_cbox512_s_per_spp    heterogeneous RGB grid volume (delta/ratio)
    knot290k_s_per_spp          290k-tri PT, 12 bounces (BVH walk)
    iteorb_s_per_spp            480k-tri PT, 24 bounces (BVH walk)
    trans/transu_cbox512_ms_per_spp   transient BDPT (warped / unwarped)

Median of BENCH_REPS timed dispatches. ROWS=vpt,bdpt,... selects a subset
(default: all). Prints one JSON object with the device it ran on; there is
no CPU fallback.
"""
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

ALL_ROWS = ("vpt", "bdpt", "rgbvol", "knot", "orb", "trans", "transu")


def timed(fn, reps):
    """Median wall time of fn(r), each call ended by block_until_ready."""
    import jax
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(r))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def main():
    import jax
    from adapt_tpu.utils.runtime import pin_platform, setup_compile_cache
    pin_platform("gpu")
    setup_compile_cache()
    import jax.numpy as jnp
    from adapt_tpu.scene.compile import load_scene

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    reps = int(os.environ.get("BENCH_REPS", "5"))
    rows = tuple(os.environ.get("ROWS", ",".join(ALL_ROWS)).split(","))
    key = jax.random.PRNGKey(0)
    out = {}

    def run(label, folder, xml, renderer, spp, r=None, **cfg_over):
        scene, cfg, _ = load_scene(os.path.join(here, "scenes", folder), xml)
        if cfg_over:
            cfg = dataclasses.replace(cfg, **cfg_over)
        f = jax.jit(lambda k: jnp.sum(
            renderer(scene, cfg, k, jnp.int32(1), spp)))
        f(key)                      # compile
        dt = timed(lambda i: f(jax.random.fold_in(key, i)), r or reps)
        return dt / spp

    if "vpt" in rows:
        from adapt_tpu.renderer.vpt import render_batch_vpt
        vpt = lambda s, c, k, i, spp: render_batch_vpt(s, c, k, i, spp, 1)
        dt = run("vpt", "vpt", "cbox.xml", vpt, 16, max_bounce=16)
        out["vpt_cbox512_ms_per_spp"] = dt * 1e3

    if "bdpt" in rows:
        from adapt_tpu.renderer.bdpt import render_batch_bdpt
        dt = run("bdpt", "cbox", "cbox.xml", render_batch_bdpt, 8,
                 max_bounce=6)
        out["bdpt_cbox512_ms_per_spp"] = dt * 1e3

    if "rgbvol" in rows:
        from adapt_tpu.renderer.vpt import render_batch_vpt
        vpt = lambda s, c, k, i, spp: render_batch_vpt(s, c, k, i, spp, 1)
        dt = run("rgbvol", "cbox", "cbox-rgbvol.xml", vpt, 2, r=3)
        out["rgbvol_cbox512_s_per_spp"] = dt

    def auto_sched(folder, xml):
        """The shipped big-scene path: a first-pass alive probe derives
        the compaction schedule (renderer/pt.py Renderer); the probe is
        amortized across a render, so the steady-state pass is what gets
        timed. An explicit ADAPT_PT_COMPACT env schedule wins over auto
        (render_batch_pt resolves it when schedule=None)."""
        if os.environ.get("ADAPT_PT_COMPACT", ""):
            return None
        import numpy as np
        from adapt_tpu.renderer.pt import probe_alive_pt
        from adapt_tpu.renderer import compact
        scene, cfg, _ = load_scene(os.path.join(here, "scenes", folder),
                                   xml)
        _, counts = probe_alive_pt(scene, cfg, key, jnp.int32(1))
        profile = np.asarray(counts, np.float64) / cfg.n_pixels
        sched = compact.derive_schedule(profile, cfg.max_bounce)
        print(f"auto schedule {xml}: {sched}", file=sys.stderr)
        return sched

    def pt_with(sched):
        from adapt_tpu.renderer.pt import render_batch_pt
        return lambda s, c, k, i, spp: render_batch_pt(
            s, c, k, i, spp, 1, schedule=sched)

    if "knot" in rows:
        sched = auto_sched("cbox", "knot290k.xml")
        dt = run("knot", "cbox", "knot290k.xml", pt_with(sched), 1, r=3)
        out["knot290k_s_per_spp"] = dt

    if "orb" in rows:
        sched = auto_sched("cbox", "ite-orb.xml")
        dt = run("orb", "cbox", "ite-orb.xml", pt_with(sched), 1, r=3)
        out["iteorb_s_per_spp"] = dt

    def run_trans(unwarp):
        """Transient BDPT pass (bins accumulate per pass on the host, so
        one pass per dispatch is the production shape). Sums EVERY
        output leaf — summing only the color would let XLA dead-code the
        time-bin histograms, timing a steady render instead."""
        from adapt_tpu.renderer.bdpt import render_pass_bdpt
        scene, cfg, _ = load_scene(os.path.join(here, "scenes", "trans"),
                                   "cbox-point.xml")
        if unwarp:
            cfg = dataclasses.replace(cfg, unwarp=True)

        def one(k):
            outp = render_pass_bdpt(scene, cfg, k, jnp.int32(1))
            return sum(jnp.sum(x) for x in jax.tree_util.tree_leaves(outp))

        f = jax.jit(one)
        f(key)
        return timed(lambda i: f(jax.random.fold_in(key, i)), reps)

    if "trans" in rows:
        out["trans_cbox512_ms_per_spp"] = run_trans(False) * 1e3

    if "transu" in rows:
        out["transu_cbox512_ms_per_spp"] = run_trans(True) * 1e3

    dev = jax.devices()[0]
    out["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
