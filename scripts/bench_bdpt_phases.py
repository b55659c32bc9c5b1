#!/usr/bin/env python
"""Decompose one BDPT pass's device cost by phase on the real chip.

Times (median of reps, one jit each): the two subpath walks alone, then
walks + each strategy group added cumulatively (s0, t1, s1, gen). The
deltas attribute the pass cost far more directly than xprof op names,
which aggregate the walk while-loop and the four strategy lax.scans into
the same op paths. Env: SCENE (cbox.xml), BOUNCES (6), REPS (5).
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
    max_bnc = min(cfg.max_bounce, B.CAP)
    N = cfg.n_pixels

    def upto(case_cut):
        """Pass with only strategy groups up to case_cut (exclusive order
        s0, t1, s1, gen); case_cut=None -> walks only."""
        order = ("s0", "t1", "s1", "gen")
        keep = order[:order.index(case_cut)] if case_cut else ()

        # B.generate_paths (the fused dual walk) measured 58.8 ms here vs
        # 50.8 for the two separate walks — see its docstring
        @jax.jit
        def run(key, cnt):
            k, k_cam, k_lit, k_con = jax.random.split(key, 4)
            cam_buf, cam_vnum = B.generate_eye_path(
                scene, cfg, k_cam, cnt, max_bnc)
            lit_buf, lit_vnum = B.generate_light_path(
                scene, cfg, k_lit, max_bnc, n_paths=N)
            out = cam_buf["pos"].sum() + lit_buf["pos"].sum() \
                + cam_vnum.sum() + lit_vnum.sum()
            if not keep:
                return out
            color_local = jnp.zeros((N, 3), jnp.float32)
            color_splat = jnp.zeros((cfg.n_pixels, 3), jnp.float32)
            t_hi = min(cfg.end_t - 1, max_bnc + 1)
            s_hi = min(cfg.end_s - 1, max_bnc + 1)
            groups = {g: [] for g in order}
            k_idx = 0
            for t in range(max(cfg.start_t, 1), t_hi + 1):
                for s in range(max(cfg.start_s, 0), s_hi + 1):
                    depth = s + t - 2
                    if (s == 1 and t == 1) or depth < 0 \
                            or depth > cfg.max_bounce:
                        continue
                    k_idx += 1
                    groups[B._strategy_case(s, t)].append((s, t, k_idx))

            def run_group(case, table, carry):
                def body(carry, row):
                    cl, cs = carry
                    rad, raster, _pt, _wo = B.connect_strategy(
                        scene, cfg, jax.random.fold_in(k_con, row[2]),
                        cam_buf, cam_vnum, lit_buf, lit_vnum,
                        row[0], row[1], case=case)
                    if case == "t1":
                        ok = raster >= 0
                        idx = jnp.where(ok, raster, cfg.n_pixels)
                        cs = cs.at[idx].add(
                            jnp.where(ok[..., None], rad, 0.0),
                            mode="drop")
                    else:
                        cl = cl + rad
                    return (cl, cs), None
                carry, _ = jax.lax.scan(body, carry,
                                        jnp.asarray(table, jnp.int32))
                return carry

            carry = (color_local, color_splat)
            for case in keep:
                if groups[case]:
                    carry = run_group(case, groups[case], carry)
            return out + carry[0].sum() + carry[1].sum()
        return run

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

    prev = 0.0
    for cut, label in ((None, "walks only"), ("t1", "+ s0 group"),
                       ("s1", "+ t1 group"), ("gen", "+ s1 group")):
        dt = timed(upto(cut))
        print(f"{label:12s}: {dt * 1e3:7.1f} ms  (delta "
              f"{(dt - prev) * 1e3:+7.1f})", flush=True)
        prev = dt
    # full pass through the real entry (includes gen group + transient off)
    full = jax.jit(
        lambda k, c: jnp.sum(B.render_pass_bdpt(scene, cfg, k, c)[0]))
    dt = timed(full)
    print(f"{'full pass':12s}: {dt * 1e3:7.1f} ms  (delta "
          f"{(dt - prev) * 1e3:+7.1f})", flush=True)


if __name__ == "__main__":
    main()
