#!/usr/bin/env python
"""Smoke test of the renderer on a CUDA card, through its normal entry
points, at the sizes users render.

    python chip_smoke.py                 # one card: every phase below
    python chip_smoke.py --multichip 4   # only the four-card path

One process, phases in order, the first failure ends the run with a
non-zero exit:

  1. device: `nvidia-smi` name and power limit (from a child that never
     imports JAX), the JAX device, and whether the native BVH builder
     loaded. No card -> exit non-zero; there is no CPU fallback.
  2. assets: the procedural meshes and volume grid the scenes need
     (scripts/gen_procedural.py) and the native library (make).
  3. compile: each renderer's dispatch at full size, compiled ahead of
     time; compile seconds and compiled.memory_analysis().
  4. kernel: the Pallas triangle kernel against the jnp chunk scan on
     512^2 rays (closest and any hit), then both inside one PT cbox 512^2
     8-bounce render_batch_pt, timed.
  5. renders: a few spp of each renderer through Renderer, checked
     finite with a non-zero mean; render.py's main() once.
  6. goldens: the five 48^2 golden passes of tests/test_goldens.py on
     the card against tests/goldens/*.npy.

The last line of stdout is {"ok": true, "device": {"platform", "kind",
"count"}}; nothing else is printed as a result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# kernel check (phase 4): share of rays whose hit/miss or prim id may
# differ between the kernel and the chunk scan (ties and grazing hits:
# FMA contraction and Triton's division round differently), and the
# bounds on t and (u, v) where both agree. t = (d - o.n) / (dir.n):
# relative error ~ a few ulp, plus an absolute part for the cancellation
# in d - o.n at scene scale (~5 units, ulp ~5e-7). u, v are differences
# of such terms, so they get the absolute bound.
MISMATCH_MAX = 1e-4
T_RTOL, T_ATOL = 2e-6, 1e-5
UV_ATOL = 1e-5
# goldens (phase 6), as tests/test_goldens.py: mean within 1e-3
# relative, every pixel within 5e-2
GOLDEN_MEAN_RTOL, GOLDEN_MAX_ABS = 1e-3, 5e-2
# --multichip (max abs difference to the one-card render of the same
# sample keys, relative to the image's peak): PT differs only by the
# pmean's summation order; BDPT also by the order of the splat
# scatter's atomic adds and the psum
MULTICHIP_TOL = {"pt": 1e-5, "bdpt": 1e-4}
# film side of every full-size render (the scenes' own 512); a rehearsal
# on the CPU sets it small
SIZE = 512
RENDER_REPS = 3           # timed dispatches per renderer after the first


def log(msg=""):
    print(msg, flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit, from a child that never imports
    JAX (a JAX child would reserve the card's memory)."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        raise SystemExit(f"chip_smoke: no CUDA card here ({e!r})")
    return out.stdout.strip()


def result_line(devices) -> str:
    """The run's last stdout line, naming the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def setup_gpu():
    """Pin JAX to CUDA (fails without a card), turn on the compile cache;
    returns the devices."""
    sys.path.insert(0, HERE)
    from adapt_tpu.utils.runtime import pin_platform, setup_compile_cache
    pin_platform("gpu")
    cache = setup_compile_cache()
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX platform is "
                         f"{devices[0].platform!r}, not 'gpu'")
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}"
        f" ({devices[0].platform}); compile cache {cache}")
    return devices


def make_assets():
    """Procedural assets (deterministic, numpy only) and the native
    library, built from the committed sources."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "gen_procedural", os.path.join(HERE, "scripts",
                                       "gen_procedural.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    for name in ("knot290k", "tornado"):
        log(f"asset {name}: {gen.ENSURE[name]()}")
    subprocess.run(["make", "-C", os.path.join(HERE, "adapt_tpu", "native"),
                    "-s"], check=True)
    from adapt_tpu import native
    loaded = native.get_lib() is not None
    log(f"native BVH library loaded: {loaded}")
    return loaded


def load(folder, xml, size=None, **over):
    """Scene + config; size resizes the film (focal rescaled, crop
    dropped)."""
    from adapt_tpu.scene.compile import load_scene
    scene, cfg, _ = load_scene(os.path.join(HERE, "scenes", folder), xml)
    if size is not None and size != cfg.w:
        over = dict(w=size, h=size, focal=cfg.focal * size / min(cfg.w,
                                                                 cfg.h),
                    start_x=0, end_x=size, start_y=0, end_y=size, **over)
    return scene, dataclasses.replace(cfg, **over) if over else cfg


def memory_summary(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


@dataclasses.dataclass
class Case:
    """One renderer at full size: how to build it, what one dispatch
    compiles, and how many spp to render."""
    name: str
    renderer: object
    spp: int
    lower: object          # () -> jax.stages.Lowered of the dispatch


def build_cases():
    import jax
    import jax.numpy as jnp
    from adapt_tpu.renderer import pt, vpt, bdpt

    key, cnt = jax.random.PRNGKey(0), jnp.int32(1)
    cases = []

    def pt_case(name, folder, xml, spp, **over):
        scene, cfg = load(folder, xml, SIZE, **over)
        r = pt.Renderer(scene, cfg)
        # a big scene's Renderer probes its alive profile once (a real
        # pass) to fix the compaction schedule its dispatch compiles with
        sched = r._schedule()
        cases.append(Case(name, r, spp, lambda: pt._render_batch_pt.lower(
            scene, cfg, key, cnt, spp, 1, sched)))

    def vpt_case(name, folder, xml, spp, **over):
        scene, cfg = load(folder, xml, SIZE, **over)
        r = vpt.VolumeRenderer(scene, cfg)
        cases.append(Case(name, r, spp, lambda: vpt._render_batch_vpt.lower(
            scene, cfg, key, cnt, spp, 1, vpt._COMPACT)))

    def bdpt_case(name, folder, xml, spp, **over):
        scene, cfg = load(folder, xml, SIZE, **over)
        r = bdpt.BDPT(scene, cfg)
        if cfg.transient:      # per-pass dispatch: bins accumulate on host
            lower = lambda: bdpt.render_pass_bdpt.lower(scene, cfg, key, cnt)
        else:
            lower = lambda: bdpt.render_batch_bdpt.lower(scene, cfg, key,
                                                         cnt, spp)
        cases.append(Case(name, r, spp, lower))

    s = f"{SIZE}^2"
    pt_case(f"pt cbox {s} 8 bounces", "cbox", "cbox.xml", 4, max_bounce=8)
    vpt_case(f"vpt cbox {s} 16 bounces", "vpt", "cbox.xml", 2,
             max_bounce=16)
    bdpt_case(f"bdpt cbox {s} 6 bounces", "cbox", "cbox.xml", 2,
              max_bounce=6)
    bdpt_case(f"transient bdpt cbox-point {s} 12 bounces", "trans",
              "cbox-point.xml", 1)
    pt_case(f"pt knot290k {s} 12 bounces (bvh)", "cbox", "knot290k.xml", 1,
            max_bounce=12)
    # depth cut from the scene's 32 to 8: XLA takes minutes to compile
    # the 32-bounce grid-volume program, and the smoke has a time limit
    vpt_case(f"vpt cbox-rgbvol {s} 8 bounces (grid volume)", "cbox",
             "cbox-rgbvol.xml", 1, max_bounce=8)
    return cases


def compile_phase(cases):
    for c in cases:
        t0 = time.perf_counter()
        compiled = c.lower().compile()
        log(f"compile {c.name}: {time.perf_counter() - t0:.3f} s, "
            f"memory {memory_summary(compiled)}")


def render_phase(cases):
    import numpy as np
    from adapt_tpu.renderer.vpt import VolumeRenderer
    for c in cases:
        r = c.renderer

        def timed():
            t0 = time.perf_counter()
            if isinstance(r, VolumeRenderer):
                r.render_batch(c.spp, fuse=1)
            else:
                r.render_batch(c.spp)
            r.color.block_until_ready()
            return time.perf_counter() - t0

        first = timed()
        steady = sorted(timed() for _ in range(RENDER_REPS))
        steady = steady[len(steady) // 2] / c.spp
        img = r.image()
        finite = bool(np.isfinite(img).all())
        mean = float(img.mean())
        log(f"render {c.name}: first call {first:.4f} s for {c.spp} spp "
            f"(compile-cache lookup included); steady "
            f"{steady * 1e3:.4f} ms/spp (median of {RENDER_REPS} "
            f"dispatches); mean {mean:.6g}, finite {finite}")
        if not finite or not mean > 0.0:
            raise SystemExit(f"chip_smoke: {c.name} image bad "
                             f"(finite={finite}, mean={mean})")
        if getattr(r, "is_transient", False):
            frames = r.transient_frames()
            if not np.isfinite(frames).all() or not frames.sum() > 0.0:
                raise SystemExit(f"chip_smoke: {c.name} transient frames "
                                 "bad")
            log(f"  transient frames {frames.shape}, sum "
                f"{float(frames.sum()):.6g}")


def check_rays(scene, cfg, n):
    """n rays against a scene: camera rays through the film plus rays
    from random interior points in random directions (bounce-like)."""
    import jax
    import jax.numpy as jnp
    from adapt_tpu.renderer.base import camera_rays
    side = int(round((n // 2) ** 0.5))
    cam = dataclasses.replace(cfg, w=side, h=side,
                              focal=cfg.focal * side / min(cfg.w, cfg.h),
                              start_x=0, end_x=side, start_y=0, end_y=side)
    ro, rd = camera_rays(scene, cam, jax.random.PRNGKey(0), jnp.int32(1))
    m = n - ro.shape[0]
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    lo = jnp.min(scene.obj_aabb_min, axis=0)
    hi = jnp.max(scene.obj_aabb_max, axis=0)
    o2 = lo + jax.random.uniform(k1, (m, 3)) * (hi - lo)
    d2 = jax.random.normal(k2, (m, 3))
    d2 = d2 / jnp.linalg.norm(d2, axis=-1, keepdims=True)
    return jnp.concatenate([ro, o2]), jnp.concatenate([rd, d2])


def kernel_check(scene, cfg, n=512 * 512):
    """The Pallas triangle kernel against the jnp chunk scan at width n,
    closest hit and any hit; raises past the stated tolerances and
    returns the measured shares and errors."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from adapt_tpu.ops.intersect import ray_intersect, does_intersect
    ro, rd = check_rays(scene, cfg, n)
    max_t = jnp.full((n,), 2.0, jnp.float32)
    res = {}
    for name, over in (("kernel", dict(use_pallas=True, use_bvh=False)),
                       ("scan", dict(use_pallas=False, use_bvh=False))):
        c = dataclasses.replace(cfg, **over)
        it = jax.jit(lambda o, d: ray_intersect(scene, c, o, d))(ro, rd)
        occ = jax.jit(lambda o, d: does_intersect(scene, c, o, d, max_t))(
            ro, rd)
        res[name] = dict(prim=np.where(np.asarray(it.obj_id) >= 0,
                                       np.asarray(it.prim_id), -1),
                         t=np.asarray(it.t), uv=np.asarray(it.uv),
                         occ=np.asarray(occ))
    k, s = res["kernel"], res["scan"]
    agree = k["prim"] == s["prim"]
    hit = agree & (s["prim"] >= 0)
    out = {
        "rays": n,
        "hits": int(hit.sum()),
        "closest_mismatch_share": float(1.0 - agree.mean()),
        "any_mismatch_share": float((k["occ"] != s["occ"]).mean()),
        "t_max_rel_err": float(np.max(np.abs(k["t"] - s["t"])[hit]
                                      / np.abs(s["t"][hit]))),
        "uv_max_abs_err": float(np.max(np.abs(k["uv"] - s["uv"])[hit])),
    }
    t_ok = np.abs(k["t"] - s["t"])[hit] <= T_RTOL * np.abs(s["t"][hit]) \
        + T_ATOL
    out["t_out_of_tol"] = int((~t_ok).sum())
    bad = (out["closest_mismatch_share"] > MISMATCH_MAX
           or out["any_mismatch_share"] > MISMATCH_MAX
           or out["t_out_of_tol"] > 0 or out["uv_max_abs_err"] > UV_ATOL)
    if bad or out["hits"] == 0:
        raise AssertionError(f"kernel vs jnp out of tolerance: {out}")
    return out


def kernel_timing(scene, cfg, spp=8, reps=5):
    """ms per spp of render_batch_pt with the Pallas kernel and with the
    chunk scan, the two in turns (kernel, scan, scan, kernel, ...)."""
    import jax
    import jax.numpy as jnp
    from adapt_tpu.renderer.pt import render_batch_pt
    key = jax.random.PRNGKey(0)
    variants = {"pallas": dataclasses.replace(cfg, use_pallas=True,
                                              use_bvh=False),
                "xla_scan": dataclasses.replace(cfg, use_pallas=False,
                                                use_bvh=False)}
    for c in variants.values():           # compile + warm up
        jax.block_until_ready(render_batch_pt(scene, c, key, jnp.int32(1),
                                              spp))
    times = {k: [] for k in variants}
    order = ["pallas", "xla_scan", "xla_scan", "pallas"]
    for r in range(reps):
        for name in order:
            t0 = time.perf_counter()
            jax.block_until_ready(render_batch_pt(
                scene, variants[name], jax.random.fold_in(key, r),
                jnp.int32(1 + r * spp), spp))
            times[name].append(time.perf_counter() - t0)
    out = {}
    for name, ts in times.items():
        ts.sort()
        out[name] = ts[len(ts) // 2] / spp * 1e3
    return out


def golden_images():
    """The five 48^2 single-pass golden renders of tests/test_goldens.py,
    keyed by golden file name."""
    import jax
    import jax.numpy as jnp
    from adapt_tpu.renderer.pt import render_pass_pt
    from adapt_tpu.renderer.vpt import render_pass_vpt
    from adapt_tpu.renderer.bdpt import render_pass_bdpt
    from adapt_tpu.renderer.ssao import depth_prepass, render_pass_ssao
    from adapt_tpu.renderer.direct import render_pass_direct

    def small(cfg, w=48):
        return dataclasses.replace(
            cfg, w=w, h=w, focal=cfg.focal * w / 512, end_x=w, end_y=w,
            max_bounce=3, anti_alias=False, stratified_sampling=False,
            use_rr=False)

    key, cnt = jax.random.PRNGKey(42), jnp.int32(1)
    scene, cfg = load("cbox", "cbox.xml")
    cfg = small(cfg)
    vscene, vcfg = load("vpt", "cbox.xml")
    return {
        "cbox_pt_48.npy": render_pass_pt(scene, cfg, key, cnt),
        "cbox_bdpt_48.npy": render_pass_bdpt(scene, cfg, key, cnt)[0],
        "vptcbox_48.npy": render_pass_vpt(vscene, small(vcfg), key, cnt),
        "cbox_ao_48.npy": render_pass_ssao(scene, cfg, key, cnt,
                                           depth_prepass(scene, cfg, key)),
        "cbox_direct_48.npy": render_pass_direct(scene, cfg, key, cnt)[0],
    }


def golden_check():
    """Each golden pass against its file; raises past the tolerance and
    returns {name: (mean rel diff, max abs diff)}."""
    import numpy as np
    out = {}
    for name, img in golden_images().items():
        gold = np.load(os.path.join(HERE, "tests", "goldens", name))
        img = np.asarray(img)
        rel = abs(img.mean() - gold.mean()) / max(gold.mean(), 1e-3)
        mx = float(np.abs(img - gold).max())
        out[name] = (float(rel), mx)
        if img.shape != gold.shape or rel >= GOLDEN_MEAN_RTOL \
                or mx >= GOLDEN_MAX_ABS:
            raise AssertionError(f"golden {name} off: shape {img.shape}, "
                                 f"mean rel {rel}, max abs {mx}")
    return out


def cli_render():
    """render.py's main() in this process (a second JAX process could not
    get the card's memory)."""
    import render
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            render.main(["--arch", "gpu", "--type", "pt",
                         "--input_path", os.path.join(HERE, "scenes"),
                         "--output_path", os.path.join(tmp, "out"),
                         "--width", "128", "--height", "128",
                         "--iter_num", "2", "--img_name", "smoke"])
            ok = os.path.exists(os.path.join(tmp, "out", "smoke.png"))
        finally:
            os.chdir(cwd)
    if not ok:
        raise SystemExit("chip_smoke: render.py wrote no image")


def multichip_check(devices, w=512):
    """MultiChipRenderer PT and BDPT on cbox w^2, 4 bounces, over an
    ('spp', 'px') mesh of `devices`, against the same shards' sample keys
    rendered one after another on the default device. Returns {kind:
    (mesh s, one-card s, max diff / peak)}; raises past MULTICHIP_TOL or
    when the output does not span every device."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from adapt_tpu.parallel.sharding import make_mesh, MultiChipRenderer
    from adapt_tpu.renderer.base import camera_rays
    from adapt_tpu.renderer.bdpt import bdpt_pass_core
    from adapt_tpu.renderer.pt import trace_pt

    mesh = make_mesh(len(devices), devices=devices)
    n_spp, n_px = mesh.shape["spp"], mesh.shape["px"]
    scene, cfg = load("cbox", "cbox.xml")
    cfg = dataclasses.replace(cfg, w=w, h=w, max_bounce=4,
                              focal=cfg.focal * w / min(cfg.w, cfg.h),
                              start_x=0, end_x=w, start_y=0, end_y=w)
    shard_n = cfg.n_pixels // n_px
    log(f"mesh {dict(mesh.shape)} over {[str(d) for d in devices]}")

    def pt_shard(key, cnt, s, p):
        k = jax.random.fold_in(jax.random.fold_in(key, s), p)
        k_cam, k_trace = jax.random.split(k)
        pix = p * shard_n + jnp.arange(shard_n, dtype=jnp.int32)
        ro, rd = camera_rays(scene, cfg, k_cam, cnt, pix_ids=pix)
        return trace_pt(scene, cfg, k_trace, ro, rd)

    def bdpt_shard(key, cnt, s, p):
        k = jax.random.fold_in(jax.random.fold_in(key, s), p)
        pix = p * shard_n + jnp.arange(shard_n, dtype=jnp.int32)
        local, splat, _b, _c = bdpt_pass_core(scene, cfg, k, cnt,
                                              pix_ids=pix)
        return local, splat

    def one_card(kind, key, cnt):
        """The mesh's pass, shard by shard on the default device."""
        fn = jax.jit(pt_shard if kind == "pt" else bdpt_shard)
        groups = []
        for s in range(n_spp):
            outs = [fn(key, cnt, jnp.int32(s), jnp.int32(p))
                    for p in range(n_px)]
            if kind == "pt":
                groups.append(jnp.concatenate(outs))
            else:
                splat = sum(o[1] for o in outs)
                groups.append(jnp.concatenate(
                    [o[0] for o in outs]) + splat)
        return sum(groups) / n_spp

    out = {}
    for kind in ("pt", "bdpt"):
        r = MultiChipRenderer(scene, cfg, mesh, bdpt=(kind == "bdpt"))
        key, cnt = jax.random.PRNGKey(7), jnp.int32(n_spp)
        step = r._step
        jax.block_until_ready(step(scene, key, cnt))          # compile
        t0 = time.perf_counter()
        got = jax.block_until_ready(step(scene, key, cnt))
        t_mesh = time.perf_counter() - t0
        shard_devs = {s.device for s in got.addressable_shards}
        if len(shard_devs) != len(devices):
            raise AssertionError(f"{kind}: output on {shard_devs}, "
                                 f"expected {len(devices)} devices")
        jax.block_until_ready(one_card(kind, key, cnt))       # compile
        t0 = time.perf_counter()
        ref = jax.block_until_ready(one_card(kind, key, cnt))
        t_one = time.perf_counter() - t0
        got, ref = np.asarray(got), np.asarray(ref)
        diff = float(np.abs(got - ref).max() / max(np.abs(ref).max(),
                                                     1e-12))
        out[kind] = (t_mesh, t_one, diff)
        log(f"multichip {kind} cbox {w}^2 4 bounces: mesh {t_mesh:.4f} s, "
            f"one card (same shards in turn) {t_one:.4f} s, max diff / peak "
            f"{diff:.3g} (tol {MULTICHIP_TOL[kind]}), shards on "
            f"{sorted(str(d) for d in shard_devs)}")
        if not np.isfinite(got).all() or diff > MULTICHIP_TOL[kind]:
            raise AssertionError(f"multichip {kind} off: diff {diff}")
        # and the user-facing path: one progressive step + image
        r.render()
        if not np.isfinite(r.image()).all():
            raise AssertionError(f"multichip {kind}: image not finite")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", type=int, default=0, metavar="N",
                    help="run only the N-card MultiChipRenderer check")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    log(f"nvidia-smi: {nvidia_smi()}")
    os.chdir(HERE)          # scene files name some assets from the root
    devices = setup_gpu()

    if args.multichip:
        if len(devices) < args.multichip:
            raise SystemExit(f"chip_smoke: --multichip {args.multichip} "
                             f"but {len(devices)} devices")
        devices = devices[:args.multichip]
        multichip_check(devices, SIZE)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(result_line(devices), flush=True)
        return

    def phase(name):
        log(f"== {name} (t = {time.perf_counter() - t_start:.1f} s)")

    phase("assets")
    make_assets()
    phase("compile")
    cases = build_cases()
    compile_phase(cases)
    phase("kernel")
    scene, cfg = load("cbox", "cbox.xml", SIZE, max_bounce=8)
    log(f"kernel vs jnp ({SIZE}^2 rays, cbox): "
        f"{kernel_check(scene, cfg, SIZE * SIZE)}")
    ms = kernel_timing(scene, cfg)
    log(f"pt cbox {SIZE}^2 8 bounces, ms/spp: pallas kernel "
        f"{ms['pallas']:.4f}, xla chunk scan {ms['xla_scan']:.4f}")
    phase("renders")
    render_phase(cases)
    cli_render()
    log("render.py --type pt: ok")
    phase("goldens")
    log(f"goldens (mean rel diff, max abs diff): {golden_check()}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(result_line(devices[:1]), flush=True)


if __name__ == "__main__":
    main()
