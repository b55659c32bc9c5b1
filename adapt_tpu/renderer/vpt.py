"""Wavefront volumetric path tracer (reference renderer/vpt.py).

Wavefront redesign of the reference's divergent per-pixel while-loop:
every bounce iteration advances the whole wavefront through

    intersect -> effective-medium select -> mean-free-path sample ->
    null-surface passthrough -> NEE (transmittance-weighted shadow rays)
    -> phase/BxDF MIS -> continuation sample

with per-lane masks. Null-surface crossings do not consume a bounce
(vpt.py:189-191 `continue` semantics), so the loop runs
max_bounce + NULL_BUDGET fixed iterations with per-lane bounce counters.

Estimator semantics follow vpt.py:54-258 with one deliberate fix: the
emission-MIS weight is computed from the *next* hit's emitter (as in
vanilla_renderer.py:109-117) rather than the current vertex's
(vpt.py:247-254) — the reference form is a latent bug that only stays
invisible because every shipped VPT scene uses delta lights.
"""
from __future__ import annotations

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp

from ..constants import MediumTag
from ..ops import bxdf_ops, emitter_ops, medium_ops
from ..ops.intersect import ray_intersect
from ..ops.math3d import dot, normalize, norm
from ..ops.sampling import balance_heuristic
from ..ops.texture_ops import get_uv_item, process_ns
from .base import ProgressiveRenderer, camera_rays, crop_pix_ids
from . import compact

NULL_BUDGET = 8       # extra loop iterations to absorb null-surface crossings
TRACK_STEPS = 7       # max medium interfaces along a shadow ray (vpt.py:113)
# bounce-loop unroll factor (amortizes per-iteration loop overhead)
_UNROLL = int(os.environ.get("ADAPT_VPT_UNROLL", "2"))
# Wavefront length-compaction schedule (machinery in renderer/compact.py),
# derived from the vpt-cbox 512^2 alive/iteration profile
# 0.93 0.73 0.63 0.56 0.43 0.36 0.30 0.25 0.21 0.15 0.11 0.08 0.07 0.05
# 0.04 0.03 ... -> 0 at 23 (ADAPT_ALIVE_STATS): splits below each
# power-of-2 alive boundary are sound. The schedule was chosen by timing
# on another accelerator; its cost on the GPU is not measured yet (each
# extra width also costs compile time). PT's probe+derive_schedule
# machinery (renderer/pt.py probe_alive_pt) is the template if per-scene
# VPT schedules are ever needed — an over-eager split only hits the
# sound lax.cond overflow branch (correct, just a wasted sort).
_COMPACT = compact.parse_schedule(
    os.environ.get("ADAPT_VPT_COMPACT", "7:2,13:8"))
# report per-iteration alive counts (schedule tuning). Works through an
# UNJITTED render_pass_vpt call only: counts are stashed as device
# scalars in _ALIVE_LOG and read by the caller afterwards.
_ALIVE_STATS = os.environ.get("ADAPT_ALIVE_STATS", "0") == "1"
_ALIVE_LOG = []


_MEDIUM_FIELDS = ("kind", "ior", "u_a", "u_s", "u_e", "ph_par", "ph_pdf")


def _gather_rows(table, idx):
    """Gather per-lane rows from a MediumTable (one shared one-hot)."""
    from ..ops.gather import tgather_pack
    vals = tgather_pack([getattr(table, f) for f in _MEDIUM_FIELDS], idx)
    return dict(zip(_MEDIUM_FIELDS, vals))


def effective_medium(scene, cfg, obj_id, in_free_space):
    """Per-lane effective medium (reference vpt.py:54-99 precedence):
    world medium when in free space and the world scatters, else the hit
    object's attached medium. Returns (rows, is_scattering)."""
    idx = jnp.maximum(obj_id, 0)
    obj_rows = _gather_rows(scene.medium, idx)
    w = scene.world_medium
    world_valid = in_free_space & cfg.world_scattering
    obj_scat = (obj_id >= 0) & (obj_rows["kind"] >= 0) & ~in_free_space
    rows = {}
    for f in obj_rows:
        wv = jnp.broadcast_to(getattr(w, f)[0], obj_rows[f].shape)
        sel = world_valid[..., None] if obj_rows[f].ndim > 1 else world_valid
        rows[f] = jnp.where(sel, wv, obj_rows[f])
    return rows, (world_valid | obj_scat)


def _is_null_surface(scene, obj_id):
    """Null BSDF = medium boundary (reference bsdf.py:238-240)."""
    from ..ops.gather import tgather
    idx = jnp.maximum(obj_id, 0)
    return (obj_id >= 0) & tgather(scene.mat_is_bsdf, idx) \
        & (tgather(scene.mat_type, idx) < 0)


def world_bound_time(scene, ray_o, ray_d):
    """Exit distance from the world AABB (reference vpt.py:139-143)."""
    w_min = jnp.min(scene.obj_aabb_min, axis=0)
    w_max = jnp.max(scene.obj_aabb_max, axis=0)
    safe_d = jnp.where(jnp.abs(ray_d) < 1e-9, 1e-9, ray_d)
    t0 = (w_min[None, :] - ray_o) / safe_d
    t1 = (w_max[None, :] - ray_o) / safe_d
    return jnp.min(jnp.maximum(t0, t1), axis=-1)


def _track_loop(scene, cfg, start_p, ray_d, depth, active):
    """Sequential restart-from-the-hit-point media walk
    (reference vpt.py:101-137): one closest-hit intersect per interface,
    at most TRACK_STEPS of them, stopping when every lane is done."""
    N = start_p.shape[0]
    w_ior = scene.world_medium.ior[0]

    def cond(st):
        # early all-lane exit: most shadow segments resolve in 1-2 steps
        # (blocked or target reached); the reference walks each ray
        # divergently (vpt.py:113-136), we stop when every lane is done
        return jnp.any(st[4]) & (st[5] < TRACK_STEPS)

    def body(st):
        tr, acc, p, remaining, alive, step = st
        it = ray_intersect(scene, cfg, p, ray_d, max_t=remaining,
                           alive=alive)
        miss = ~it.is_hit
        seg = jnp.where(miss, remaining, it.t)
        in_free = jnp.where(miss, True, dot(it.n_g, ray_d) < 0.0)
        blocked = (~miss & ~_is_null_surface(scene, it.obj_id) & alive
                   if cfg.has_null_bsdf else ~miss & alive)
        rows, scat = effective_medium(scene, cfg, it.obj_id, in_free)
        seg_tr = medium_ops.transmittance(rows["u_e"], scat, seg)
        ior = jnp.where(in_free, w_ior, rows["ior"])
        tr = jnp.where(blocked[..., None], 0.0,
                       jnp.where(alive[..., None], tr * seg_tr, tr))
        acc = acc + jnp.where(alive, seg * ior, 0.0)
        p = p + ray_d * seg[..., None]
        remaining = remaining - seg
        # stop on block, reaching target, or escaping a non-scattering world
        alive = alive & ~blocked & (remaining > 5e-5)
        if not cfg.world_scattering:
            alive &= ~miss
        return tr, acc, p, remaining, alive, step + 1

    alive0 = jnp.ones((N,), bool) if active is None else active
    init = (jnp.ones((N, 3), jnp.float32), jnp.zeros((N,), jnp.float32),
            start_p, depth, alive0, jnp.int32(0))
    tr, acc, *_ = jax.lax.while_loop(cond, body, init)
    return tr, acc


def track_ray(scene, cfg, start_p, ray_d, depth, key=None, thp=None,
              active=None):
    """Transmittance + ior-weighted propagation time along a shadow path
    crossing up to TRACK_STEPS medium interfaces (reference vpt.py:101-137).

    Returns (tr (N,3), acc_depth (N,)). tr = 0 where a non-null surface
    blocks the segment. key/thp are required when the scene has a grid
    volume (ratio-tracking transmittance, vpt.py:110-112). active: dead
    lanes skip all intersection work (their tr/time are unused)."""
    N = start_p.shape[0]
    w_ior = scene.world_medium.ior[0]
    if not (cfg.world_scattering or cfg.has_null_bsdf or cfg.volume_kind
            or cfg.medium_kinds):
        # static fast path: no media anywhere -> binary occlusion
        from ..ops.intersect import does_intersect
        occ = does_intersect(scene, cfg, start_p, ray_d, depth,
                             alive=active)
        return (jnp.where(occ[..., None], 0.0, 1.0)
                * jnp.ones((N, 3), jnp.float32)), depth * w_ior
    vol_tr = 1.0
    if cfg.volume_kind:
        from ..ops import volume_ops
        key, k_vol = jax.random.split(key)
        vol_tr = volume_ops.eval_tr_ratio_tracking(
            scene.volume, cfg.volume_kind, k_vol, start_p, ray_d,
            jnp.ones((N, 3)) if thp is None else thp, depth,
            active=active)

    tr, acc = _track_loop(scene, cfg, start_p, ray_d, depth, active)
    return tr * vol_tr, acc


def render_pass_vpt(scene, cfg, key, cnt, schedule=None):
    """Thin unjitted wrapper: the compaction schedule is resolved HERE
    (None -> the ADAPT_VPT_COMPACT module default) and passed as a
    STATIC jit argument — reading a module global inside the jitted body
    would bake the first caller's schedule into the cache and silently
    serve it to every later call (the r5 A/B-aliasing bug)."""
    if schedule is None:
        schedule = _COMPACT
    return _render_pass_vpt(scene, cfg, key, cnt, schedule)


@partial(jax.jit, static_argnames=("cfg", "schedule"))
def _render_pass_vpt(scene, cfg, key, cnt, schedule):
    # crop windows trace ONLY crop pixels (reference tracer_base.py:39-55)
    pix = crop_pix_ids(cfg)
    key, cam_key = jax.random.split(key)
    ray_o, ray_d = camera_rays(scene, cfg, cam_key, cnt, pix_ids=pix)
    color = trace_vpt(scene, cfg, key, ray_o, ray_d, schedule=schedule)
    if pix is None:
        return color
    return jnp.zeros((cfg.n_pixels, 3), jnp.float32).at[pix].set(color)


def render_batch_vpt(scene, cfg, key, cnt0, spp, fuse=1, schedule=None):
    """Unjitted wrapper resolving the compaction schedule (see
    render_pass_vpt)."""
    if schedule is None:
        schedule = _COMPACT
    return _render_batch_vpt(scene, cfg, key, cnt0, spp, fuse, schedule)


@partial(jax.jit, static_argnames=("cfg", "spp", "fuse", "schedule"))
def _render_batch_vpt(scene, cfg, key, cnt0, spp, fuse, schedule):
    """spp samples in one dispatch; fuse samples share one wide wavefront
    (same launch-overhead amortization as renderer/pt.py)."""
    fuse = max(1, min(fuse, spp))
    iters = spp // fuse
    pix = crop_pix_ids(cfg)
    Nt = cfg.n_pixels if pix is None else int(pix.shape[0])

    def body(i, acc):
        sub = jax.random.fold_in(key, i)
        ros, rds = [], []
        for j in range(fuse):
            k_cam, _ = jax.random.split(jax.random.fold_in(sub, j))
            ro, rd = camera_rays(scene, cfg, k_cam, cnt0 + i * fuse + j,
                                 pix_ids=pix)
            ros.append(ro)
            rds.append(rd)
        color = trace_vpt(scene, cfg, jax.random.fold_in(sub, 7919),
                          jnp.concatenate(ros, 0), jnp.concatenate(rds, 0),
                          schedule=schedule)
        return acc + jnp.nan_to_num(color,
                                    nan=0.0).reshape(fuse, Nt, 3).sum(0)

    acc = jax.lax.fori_loop(0, iters, body, jnp.zeros((Nt, 3), jnp.float32))
    for r in range(spp - iters * fuse):
        sub = jax.random.fold_in(key, iters + 1000 + r)
        k_tr, cam_key = jax.random.split(sub)
        ro, rd = camera_rays(scene, cfg, cam_key,
                             cnt0 + iters * fuse + r, pix_ids=pix)
        acc = acc + jnp.nan_to_num(trace_vpt(scene, cfg, k_tr, ro, rd,
                                             schedule=schedule), nan=0.0)
    if pix is None:
        return acc
    return jnp.zeros((cfg.n_pixels, 3), jnp.float32).at[pix].set(acc)


def trace_vpt(scene, cfg, key, ray_o, ray_d, schedule=None):
    """Trace a (N,3) wavefront with participating media.

    schedule: length-compaction splits (STATIC; None -> module default
    ADAPT_VPT_COMPACT — only safe outside jit)."""
    if schedule is None:
        schedule = _COMPACT
    N = ray_o.shape[0]
    world_ior = scene.world_medium.ior[0]
    # a miss can still scatter when the world medium or a grid volume fills
    # open space (reference vpt.py:173-179)
    media_everywhere = cfg.world_scattering or bool(cfg.volume_kind)
    phase_kinds = tuple(sorted(set(cfg.medium_kinds)
                               | ({cfg.volume_phase} if cfg.volume_kind
                                  else set())))

    S = max(cfg.num_shadow_ray, 1)
    D = 9 + 4 * S                   # uniforms consumed per iteration

    init = dict(
        ray_o=ray_o, ray_d=ray_d,
        it=ray_intersect(scene, cfg, ray_o, ray_d),
        color=jnp.zeros((N, 3), jnp.float32),
        thp=jnp.ones((N, 3), jnp.float32),
        emission_weight=jnp.ones((N,), jnp.float32),
        active=jnp.ones((N,), bool),
        bounce=jnp.zeros((N,), jnp.int32),
        pos=jnp.arange(N, dtype=jnp.int32),
    )

    def iteration(_i, st):
        active = st["active"]
        thp = st["thp"]
        ray_o, ray_d = st["ray_o"], st["ray_d"]
        n = active.shape[0]
        # per-lane counter RNG: draws keyed by (iteration, ORIGINAL lane
        # id) so a compaction sort cannot change any lane's realization
        it_key = jax.random.fold_in(key, _i)
        u_all = compact.lane_uniform(it_key, st["pos"], D)

        # --- RR termination (vpt.py:160-168) ---
        max_val = jnp.max(thp, axis=-1)
        if cfg.use_rr:
            cand = (max_val < cfg.rr_threshold) & (st["bounce"]
                                                   >= cfg.rr_bounce_th)
            killed = cand & (u_all[:, 0] > max_val)
            thp = thp * jnp.where(cand, 1.0 / (max_val + 1e-7), 1.0)[..., None]
            active &= ~killed
        else:
            active &= max_val >= 1e-5

        # --- intersect + world-medium fallback (vpt.py:170-181) ---
        # the interaction is carried from the previous iteration's
        # next-segment intersect (one closest-hit per bounce, not two —
        # the MIS block used to re-trace the same segment). RR-killed
        # lanes may carry a stale hit instead of a forced miss; every
        # consumer below is masked by `active`, so only dead-lane
        # garbage (never radiance) differs.
        it = st["it"]
        miss = ~it.is_hit
        if media_everywhere:
            wb = world_bound_time(scene, ray_o, ray_d)
            depth = jnp.where(miss, jnp.maximum(wb, 0.0), it.t)
        else:
            depth = it.t
            active &= it.is_hit
        in_free = jnp.where(miss, True, dot(it.n_g, ray_d) < 0.0)
        obj_id = it.obj_id

        # --- mean free path sampling (vpt.py:183-186) ---
        rows, scat = effective_medium(scene, cfg, obj_id, in_free)
        u_mfp = u_all[:, 1:3]
        is_mi, mfp, beta = medium_ops.sample_mfp(
            rows["u_e"], rows["u_s"], scat, depth, u_mfp)
        if cfg.volume_kind:
            # grid-volume event overrides the world-medium event
            # (vpt.py:93-99, is_mi = 2 semantics)
            from ..ops import volume_ops
            k_vol = jax.random.fold_in(it_key, 7001)
            v_t, v_beta = volume_ops.sample_distance_delta_tracking(
                scene.volume, cfg.volume_kind, k_vol, ray_o, ray_d, thp,
                depth, active=active)
            is_vol = v_t > 0.0
            mfp = jnp.where(is_vol, v_t, mfp)
            beta = jnp.where(is_vol[..., None], v_beta, beta)
            is_mi = is_mi | is_vol
            # medium rows switch to the volume's phase function
            vol_kind = jnp.full((n,), cfg.volume_phase, jnp.int32)
            rows = dict(rows)
            rows["kind"] = jnp.where(is_vol, vol_kind, rows["kind"])
            rows["ph_par"] = jnp.where(is_vol[..., None],
                                       scene.volume.ph_par[None, :],
                                       rows["ph_par"])
            rows["ph_pdf"] = jnp.where(is_vol[..., None],
                                       scene.volume.ph_pdf[None, :],
                                       rows["ph_pdf"])
        active &= ~(miss & ~is_mi)           # exited the world bound
        hit_point = ray_o + ray_d * mfp[..., None]
        thp = thp * jnp.where(active[..., None], beta, 1.0)

        # --- null surface passthrough (vpt.py:189-191) ---
        is_null = (~is_mi & _is_null_surface(scene, obj_id)
                   if cfg.has_null_bsdf else jnp.zeros_like(active))
        shade = active & ~is_null

        mat = bxdf_ops.gather_mat(scene, obj_id)
        hit_light = jnp.where(is_mi | miss, -1, mat.emit)
        it = process_ns(scene, cfg, it)
        # static identity for untextured scenes (it.tex stays None; see
        # ops/intersect.py / bxdf_ops.diffuse_color)
        it_s = it
        if scene.tex["albedo"].present:
            tex, _ = get_uv_item(scene, scene.tex["albedo"], it)
            it_s = dataclasses.replace(it, tex=tex)

        # --- NEE with transmittance (vpt.py:194-237) ---
        direct_int = jnp.zeros((n, 3), jnp.float32)
        for _s in range(cfg.num_shadow_ray):
            u_pick = u_all[:, 3 + 4 * _s]
            eid, emitter_pdf, valid = emitter_ops.sample_light_index(
                cfg, u_pick, hit_light)
            u_hit = u_all[:, 4 + 4 * _s:7 + 4 * _s]
            emit_pos, shadow_int, direct_pdf, _n = emitter_ops.sample_hit(
                scene, cfg, eid, hit_point, u_hit)
            to_e = emit_pos - hit_point
            e_d = norm(to_e)
            l_dir = to_e / jnp.maximum(e_d[..., None], 1e-12)
            k_tr = jax.random.fold_in(it_key, 7101 + _s)
            tr, _t = track_ray(scene, cfg, hit_point, l_dir, e_d,
                               key=k_tr, thp=thp, active=active)
            shadow_int = shadow_int * tr
            # eval: phase value for medium events, BxDF for surface
            ph_val = medium_ops.phase_eval(rows["kind"], rows["ph_par"],
                                           rows["ph_pdf"], ray_d, l_dir,
                                           phase_kinds)
            surf_val = bxdf_ops.surface_eval(cfg, mat, it_s, ray_d, l_dir,
                                             world_ior, scene=scene)
            d_spec = jnp.where(is_mi[..., None],
                               jnp.broadcast_to(ph_val[..., None], (n, 3)),
                               surf_val)
            if cfg.use_mis:
                light_pdf = emitter_pdf * direct_pdf
                bsdf_pdf = jnp.where(
                    is_mi, ph_val,
                    bxdf_ops.surface_pdf(cfg, mat, it_s, l_dir, ray_d,
                                         world_ior, scene=scene))
                mis_w = jnp.where(emitter_ops.is_delta_pos(scene, eid), 1.0,
                                  balance_heuristic(light_pdf, bsdf_pdf))
            else:
                mis_w = jnp.ones((n,), jnp.float32)
            contrib = d_spec * shadow_int * (mis_w / emitter_pdf)[..., None]
            direct_int = direct_int + jnp.where(valid[..., None], contrib,
                                                0.0)
        direct_int = direct_int / float(max(cfg.num_shadow_ray, 1))

        # --- emission on hitting a light (vpt.py:240-242) ---
        emit_le = emitter_ops.eval_le(scene, jnp.maximum(hit_light, 0),
                                      hit_point - ray_o, it.n_g)
        emit_int = jnp.where((hit_light >= 0)[..., None], emit_le, 0.0)

        # --- continuation sampling (vpt.py:245) ---
        u_new = u_all[:, 3 + 4 * S:9 + 4 * S]
        s_dir, s_spec, s_pdf, is_specular = bxdf_ops.surface_sample(
            cfg, mat, it_s, ray_d, u_new, world_ior, scene=scene)
        p_dir, p_val = medium_ops.phase_sample(
            rows["kind"], rows["ph_par"], rows["ph_pdf"], ray_d,
            u_new[:, :3], phase_kinds)
        new_dir = jnp.where(is_mi[..., None], p_dir, s_dir)
        # medium: perfect importance sampling -> spec/pdf = 1
        cont = jnp.where(is_mi[..., None], 1.0,
                         s_spec / jnp.maximum(s_pdf, 1e-9)[..., None])
        dead = ~is_mi & ((jnp.max(s_spec, -1) <= 0.0) | (s_pdf <= 0.0))

        color = st["color"] + jnp.where(
            shade[..., None],
            (direct_int + emit_int * st["emission_weight"][..., None]) * thp,
            0.0)
        thp = thp * jnp.where(shade[..., None], cont, 1.0)

        # null lanes keep their direction; shaded lanes take the new one
        out_dir = jnp.where((is_null & ~is_mi)[..., None], ray_d, new_dir)
        bounce = st["bounce"] + jnp.where(shade, 1, 0)
        active &= ~(shade & dead)
        active &= bounce < cfg.max_bounce

        # --- next-segment intersect, reused as next iteration's `it` ---
        # skipped on the last iteration: it (and the emission weight it
        # feeds) is only consumed by the following one
        it_n = jax.lax.cond(
            _i < iters - 1,
            lambda: ray_intersect(scene, cfg, hit_point, out_dir,
                                  alive=active),
            lambda: jax.tree_util.tree_map(jnp.zeros_like, st["it"]))
        # --- emission MIS weight from the NEXT hit (vanilla:109-117) ---
        if cfg.use_mis:
            mat_n = bxdf_ops.gather_mat(scene, it_n.obj_id)
            nl = jnp.where(it_n.obj_id >= 0, mat_n.emit, -1)
            n_delta = mat_n.is_delta
            can = (nl >= 0) & ~n_delta & ~is_specular
            e_pdf = jnp.where(can, emitter_ops.solid_angle_pdf(
                scene, jnp.maximum(nl, 0), it_n.n_s, it_n.t, out_dir), 0.0)
            ray_pdf = jnp.where(is_mi, p_val, s_pdf)
            emission_weight = jnp.where(
                shade, balance_heuristic(ray_pdf, e_pdf),
                st["emission_weight"])
        else:
            emission_weight = st["emission_weight"]

        return dict(ray_o=hit_point, ray_d=out_dir, it=it_n,
                    color=color, thp=thp, emission_weight=emission_weight,
                    active=active, bounce=bounce, pos=st["pos"])

    # null crossings are the only way an iteration advances without
    # incrementing `bounce` (shade = active & ~is_null; medium
    # interactions shade), so only cfg.has_null_bsdf needs the budget —
    # `or media_everywhere` ran provably-inert extra iterations
    iters = cfg.max_bounce + (NULL_BUDGET if cfg.has_null_bsdf else 0)

    # split payload reduction: the carried interaction is recomputable
    # from (ray_o, ray_d) — a narrow re-intersect is far cheaper than
    # sorting its 12 extra operands (the full-state global sort's
    # compile walked off a cliff at 512^2; see compact.run_compacted)
    def reduce_fn(st):
        return {k: st[k] for k in ("ray_o", "ray_d", "color", "thp",
                                   "emission_weight", "active", "bounce",
                                   "pos")}

    def restore_fn(core):
        it = ray_intersect(scene, cfg, core["ray_o"], core["ray_d"],
                           alive=core["active"])
        return dict(core, it=it)

    return compact.run_compacted(
        iteration, init, iters, schedule, _UNROLL,
        alive_log=_ALIVE_LOG if _ALIVE_STATS else None,
        reduce_fn=reduce_fn, restore_fn=restore_fn)


class VolumeRenderer(ProgressiveRenderer):
    """Volumetric renderer final class (reference vpt.py:29)."""

    def render_pass(self, key, cnt):
        return render_pass_vpt(self.scene, self.cfg, key,
                               jnp.asarray(cnt, jnp.int32))

    def render_batch(self, spp: int, fuse: int = 4):
        self.key, sub = jax.random.split(self.key)
        acc = render_batch_vpt(self.scene, self.cfg, sub,
                               jnp.int32(self.cnt + 1), spp, fuse)
        self.cnt += spp
        self.color = self.color + acc.reshape(self.cfg.w, self.cfg.h, 3)
        return self.color
