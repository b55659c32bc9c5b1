"""Wavefront bidirectional path tracer (reference renderer/bdpt.py).

Wavefront redesign: both subpaths are generated by batched random walks
that scatter into fixed-size depth-major SoA vertex buffers ((D, N)
scalars / (3, D, N) vec3, see _vertex_buffers); every
(t, s) connection strategy is a fully-unrolled batched evaluation (t and s
are static Python ints, so the PBRT-style MIS ratio sweep unrolls at trace
time instead of running a divergent per-pixel loop). t==1 strategies splat
into the framebuffer with a masked scatter-add (the reference's atomic
+=, bdpt.py:159-162).

Faithfulness notes (gate is parity with the reference's rendered output):
 * pdf_camera returns 0 exactly like the reference's latent bug
   (bdpt.py:530-539 — the numerator is never set), so camera-subpath
   pdf_fwd chains start at remap_pdf(0)=1 in MIS;
 * TRANSIENT_LIT falls back to TRANSIENT_CAM (bdpt.py:42-46);
 * vertices on null surfaces are skipped, grid-volume vertices use the
   surrounding homogeneous medium's phase in connections (bdpt.py:204-304).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..constants import (VERTEX_SURFACE, VERTEX_MEDIUM, VERTEX_EMITTER,
                         VERTEX_CAMERA, TRANSPORT_RAD, TRANSPORT_IMP,
                         EmitterTag)
from ..ops import bxdf_ops, emitter_ops, medium_ops
from ..ops.gather import tgather
from ..ops.intersect import ray_intersect, Interaction
from ..ops.math3d import dot, normalize, norm
from ..ops.texture_ops import get_uv_item, process_ns
from .base import ProgressiveRenderer, camera_rays, crop_mask
from .vpt import effective_medium, _is_null_surface, world_bound_time, \
    track_ray

CAP = 32            # max vertices per subpath - 1 (reference N_MAX_BOUNCE=32,
#                     bdpt.py:29). Depth rides the sublane axis of the
#                     depth-major (D,N)/(3,D,N) buffers, so doubling it only
#                     grows the vertex SoA linearly; the real cost of deep
#                     caps is the statically-unrolled (t,s) strategy count
#                     (O(max_bounce^2) connect_strategy instances), which is
#                     why the cap is still finite.
CAP_CROP = 400      # crop-window cap (reference T_MAX_BOUNCE=400,
#                     bdpt.py:30): buffers scale with crop pixels, so deep
#                     transient paths stay affordable exactly as in the
#                     reference's crop-aware field layout.
NULL_BUDGET = 4
# flat-batch sizing: each chunk runs its strategies as one (K*N,)
# wavefront through connect_strategy (per-fusion overhead paid once per
# chunk instead of once per strategy). Chunks are traced bodies, so too
# many of them would blow compile time — past the chunk cap a group
# falls back to the O(1)-trace lax.scan (deep transient crops); tests
# monkeypatch FLAT_MAX_CHUNKS=0 to force-cover the scan path at toy N
FLAT_LANES = 4 << 20
FLAT_MAX_CHUNKS = 4
# Length compaction (renderer/compact.py) is not applied to BDPT: its
# state is the (D, N) vertex buffers (~22 fields x D rows, ~160 (N,)
# operands at 512^2), and one multi-operand lax.sort over that many
# operands compiles far too slowly (compact.run_compacted docstring). The
# PT/VPT escape (slim core + re-intersect restore) does not exist here:
# the buffers ARE the walk's product, not recomputable from a slim core.


def splat_sorted(film, ii, rr):
    """Add the t=1 light-tracing splats rr (M, 3) into film (P, 3) at
    pixel ids ii (M,): ONE pixel-sorted scatter-add for every t=1 strategy
    (exact up to f32 add order). Ids outside [0, P) are dropped, so
    callers mark dead lanes with any out-of-range id. On the GPU XLA
    lowers the scatter to atomic adds."""
    ii, r0, r1, r2 = jax.lax.sort(
        [ii, rr[:, 0], rr[:, 1], rr[:, 2]], num_keys=1)
    return jax.lax.scatter_add(
        film, ii[:, None], jnp.stack([r0, r1, r2], -1),
        jax.lax.ScatterDimensionNumbers(
            update_window_dims=(1,), inserted_window_dims=(0,),
            scatter_dims_to_operand_dims=(0,)),
        indices_are_sorted=True, unique_indices=False,
        mode=jax.lax.GatherScatterMode.FILL_OR_DROP)


# vertex bool bits (reference path_utils.py / bdpt.py get_bool)
B_POS_DELTA = 0x01
B_DIR_DELTA = 0x02
B_IS_AREA = 0x04
B_IN_FSPACE = 0x10
B_SPEC_DELTA = 0x20


def _remap(x):
    """remap_pdf (reference path_utils.py:13-15)."""
    return jnp.where(x > 0.0, x, 1.0)


def _vertex_buffers(N, D, has_tex):
    """Depth-major SoA vertex storage.

    Scalars are (D, N), vec3 fields (3, D, N): the minor axis is the
    wavefront dim, so every per-depth row is one contiguous (N,) slab.
    The pixel-major (N, D) layout padded the small D axis inside XLA's
    fusion temps (a 9.8x memory expansion, measured on another
    accelerator, that ran 512^2 12-bounce renders out of memory).

    has_tex (static): untextured scenes carry NO tex plane at all
    (None) — matching ops/intersect.py's statically-None it.tex and
    saving a dead (3, D, N) array in every strategy-scan carry."""
    f = jnp.zeros
    return dict(
        vtype=jnp.full((D, N), -1, jnp.int32),
        obj_id=jnp.full((D, N), -1, jnp.int32),
        emit_id=jnp.full((D, N), -1, jnp.int32),
        bits=f((D, N), jnp.int32),
        pdf_fwd=f((D, N), jnp.float32),
        pdf_bwd=f((D, N), jnp.float32),
        time=f((D, N), jnp.float32),
        n_s=f((3, D, N), jnp.float32),
        n_g=f((3, D, N), jnp.float32),
        pos=f((3, D, N), jnp.float32),
        ray_in=f((3, D, N), jnp.float32),
        beta=f((3, D, N), jnp.float32),
        tex=(jnp.full((3, D, N), -1.0, jnp.float32) if has_tex else None),
    )


def _slot_onehot(buf, slot, mask=None):
    D = buf["vtype"].shape[0]
    oh = jnp.arange(D, dtype=slot.dtype)[:, None] == slot[None, :]
    if mask is not None:
        oh &= mask[None, :]
    return oh


def _write_vertex(buf, slot, mask, **vals):
    """Masked per-lane write into a vertex slot.

    One-hot masked select over the (D<=17, N) depth axis instead of a
    per-lane scatter. vals keep their wavefront-native (N,)/(N,3)
    shapes."""
    oh = _slot_onehot(buf, slot, mask)
    out = dict(buf)
    for k, v in vals.items():
        if buf[k] is None:        # statically-absent plane (tex)
            continue
        if buf[k].ndim == 2:
            out[k] = jnp.where(oh, v[None, :], buf[k])
        else:
            out[k] = jnp.where(oh[None], v.T[:, None, :], buf[k])
    return out


def _write_vertex_at(buf, idx, mask, **vals):
    """Masked write into ONE depth row (traced row index).

    Valid whenever every lane that places at walk-iteration i places
    into slot i+1 — true for scenes with no null BSDFs (nulls are the
    only events that advance a ray without placing; `active` is monotone
    decreasing, so an active lane has placed at every prior iteration
    and its vnum equals the iteration index). The general _write_vertex
    one-hot rewrites every (D, N) plane per iteration (~2*D*N*25 floats
    of device-memory traffic per walk step); this
    touches a single row per field instead."""
    out = dict(buf)
    for k, v in vals.items():
        if buf[k] is None:        # statically-absent plane (tex)
            continue
        if buf[k].ndim == 2:
            old = jax.lax.dynamic_index_in_dim(buf[k], idx, 0,
                                               keepdims=False)
            new = jnp.where(mask, v, old)
            out[k] = jax.lax.dynamic_update_index_in_dim(buf[k], new,
                                                         idx, 0)
        else:
            old = jax.lax.dynamic_index_in_dim(buf[k], idx, 1,
                                               keepdims=False)   # (3, N)
            new = jnp.where(mask[None, :], v.T, old)
            out[k] = jax.lax.dynamic_update_index_in_dim(buf[k], new,
                                                         idx, 1)
    return out


def _gather_vertex(buf, slot):
    """Per-lane gather of one vertex slot -> dict of (N,...) arrays
    (one-hot reduction over the depth axis)."""
    oh = _slot_onehot(buf, slot)
    out = {}
    for k, v in buf.items():
        if v is None:             # statically-absent plane (tex)
            out[k] = None
        elif v.ndim == 2:
            if v.dtype == jnp.bool_:
                out[k] = jnp.any(v & oh, axis=0)
            else:
                out[k] = jnp.sum(jnp.where(oh, v, 0), axis=0)
        else:
            out[k] = jnp.sum(jnp.where(oh[None], v, 0), axis=1).T
    return out


def _static_vertex(buf, idx):
    """Gather a statically-indexed vertex slot."""
    return {k: (None if v is None else v[idx] if v.ndim == 2
                else v[:, idx].T)
            for k, v in buf.items()}


def _dyn_vertex(buf, idx):
    """Vertex slot `idx` (traced scalar) -> dict of (N,)/(N,3) rows.

    Depth is the LEADING axis of the depth-major buffers, so a traced slot
    index is one contiguous dynamic row slice per field — dense, not a
    per-lane gather. This is what lets the (s,t) strategy loop run as a
    lax.scan with traced indices instead of unrolling O(max_bounce^2)
    strategy bodies at trace time."""
    out = {}
    for k, v in buf.items():
        if v is None:             # statically-absent plane (tex)
            out[k] = None
        elif v.ndim == 2:
            out[k] = jax.lax.dynamic_index_in_dim(v, idx, 0, keepdims=False)
        else:
            out[k] = jax.lax.dynamic_index_in_dim(v, idx, 1,
                                                  keepdims=False).T
    return out


def _strategy_case(s, t):
    """Static connection-case tag of a (s,t) strategy (the reference's four
    connect_path branches, bdpt.py:306-410)."""
    return "s0" if s == 0 else ("t1" if t == 1 else
                                ("s1" if s == 1 else "gen"))


# ------------------------------ vertex helpers ------------------------------

def _is_connectible(v):
    surf_or_emit = (v["vtype"] == VERTEX_SURFACE) \
        | (v["vtype"] == VERTEX_EMITTER)
    return jnp.where(surf_or_emit, (v["bits"] & B_DIR_DELTA) == 0, True)


def _not_delta(v):
    return (v["bits"] & B_SPEC_DELTA) == 0


def _not_delta_source(v):
    return (v["bits"] & (B_POS_DELTA | B_DIR_DELTA)) == 0


def _has_normal(v):
    return jnp.any(v["n_s"] != 0.0, axis=-1)


def _is_light_v(v):
    return (v["vtype"] == VERTEX_EMITTER) | ((v["bits"] & B_IS_AREA) > 0)


def _in_fspace(v):
    return (v["bits"] & B_IN_FSPACE) > 0


def _is_mi_v(v):
    return v["vtype"] == VERTEX_MEDIUM


def _interaction_of(v):
    N = v["vtype"].shape[0]
    return Interaction(obj_id=v["obj_id"], prim_id=jnp.zeros_like(v["obj_id"]),
                       t=jnp.zeros((N,), jnp.float32), n_g=v["n_g"],
                       n_s=v["n_s"], uv=jnp.zeros((N, 2), jnp.float32),
                       tex=v["tex"])


def _get_pdf_bwd(v_pos, v_ns, v_has_n, pdf_sa, next_point):
    """Solid-angle -> area measure at vertex v (path_utils.py:52-63)."""
    diff = v_pos - next_point
    n2 = jnp.maximum(jnp.sum(diff * diff, -1), 1e-12)
    pdf = pdf_sa / n2
    cosine = jnp.abs(dot(v_ns, diff / jnp.sqrt(n2)[..., None]))
    pdf = jnp.where(v_has_n, pdf * cosine, pdf)
    return jnp.where(pdf_sa > 0.0, pdf, 0.0)


def _convert_density(pdf_sa, diff, next_ns, next_mi):
    """Solid-angle -> area density at the NEXT vertex (bdpt.py:593-604)."""
    n2 = jnp.maximum(jnp.sum(diff * diff, -1), 1e-12)
    pdf = pdf_sa / n2
    cosine = jnp.abs(dot(next_ns, diff / jnp.sqrt(n2)[..., None]))
    pdf = jnp.where(next_mi, pdf, pdf * cosine)
    return jnp.where(pdf_sa > 0.0, pdf, 0.0)


def _correct_shading_normal(n_s, n_g, incid, outd, is_mi, mode):
    """Importance-transport shading-normal factor (bdpt.py:584-591).

    mode may be a static int or a per-lane (N,) array (the fused dual
    walk runs radiance and importance lanes in one wavefront)."""
    if isinstance(mode, int):
        if mode != TRANSPORT_IMP:
            return jnp.ones(incid.shape[:-1], jnp.float32)
        imp = None
    else:
        imp = mode == TRANSPORT_IMP
    num = dot(n_s, outd) * dot(n_g, incid)
    den = dot(n_g, outd) * dot(n_s, incid)
    val = jnp.abs(num / jnp.where(jnp.abs(den) < 1e-9, 1e-9, den))
    val = jnp.where(is_mi, 1.0, val)
    return val if imp is None else jnp.where(imp, val, 1.0)


# ------------------------------- camera model -------------------------------

def _cam_normal(scene):
    return scene.cam_r @ jnp.array([0.0, 0.0, 1.0], jnp.float32)


def _film_area(cfg):
    inv_f = 1.0 / cfg.focal
    return float(cfg.w * cfg.h) * inv_f * inv_f


def _rasterize_pinhole(cfg, lx, ly):
    """Film-plane coords -> pixel indices (bdpt.py:493-506)."""
    pi = jnp.floor(cfg.w * 0.5 + 1.0 - lx * cfg.focal).astype(jnp.int32)
    pj = jnp.floor(cfg.h * 0.5 + 1.0 + ly * cfg.focal).astype(jnp.int32)
    ok = (pi >= cfg.start_x) & (pj >= cfg.start_y) \
        & (pi < cfg.end_x) & (pj < cfg.end_y)
    return pi, pj, ok


def sample_camera(scene, cfg, ray_d, depth):
    """Camera importance We + sa-pdf + raster pos (bdpt.py:508-528).

    ray_d points TOWARD the camera."""
    cam_n = _cam_normal(scene)
    dot_n = -dot(ray_d, cam_n)
    local = (-ray_d) @ scene.cam_r        # inv rotation
    z = local[..., 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    pi, pj, ok_r = _rasterize_pinhole(cfg, local[..., 0] / safe_z,
                                      local[..., 1] / safe_z)
    valid = (dot_n > 0.0) & (z > 0.0) & ok_r
    A = _film_area(cfg)
    pdf = jnp.where(valid, depth * depth / jnp.maximum(dot_n, 1e-9), 0.0)
    we = jnp.where(valid, 1.0 / (A * jnp.maximum(dot_n, 1e-9) ** 4), 0.0)
    pi = jnp.where(valid, pi, -1)
    pj = jnp.where(valid, pj, -1)
    return we, pdf, pi, pj


def pdf_camera(cfg, dot_normal):
    """Reference bdpt.py:530-539 — returns 0 (latent bug kept for output
    parity; the correct value would be 1/(A cos^3))."""
    return jnp.zeros_like(dot_normal)


# ----------------------------- vertex-space eval ----------------------------

def _phase_kinds(cfg):
    return tuple(sorted(set(cfg.medium_kinds)
                        | ({cfg.volume_phase} if cfg.volume_kind
                           else set())))


def eval_vertex(scene, cfg, v, out_dir, mode):
    """fr at vertex v toward out_dir (PathTracer.eval semantics:
    path_tracer.py:459-479): phase value for medium vertices, BxDF
    (cosine-weighted) for surface vertices."""
    is_mi = _is_mi_v(v)
    in_free = _in_fspace(v)
    rows, _ = effective_medium(scene, cfg, v["obj_id"], in_free)
    ph = medium_ops.phase_eval(rows["kind"], rows["ph_par"], rows["ph_pdf"],
                               v["ray_in"], out_dir, _phase_kinds(cfg))
    mat = bxdf_ops.gather_mat(scene, v["obj_id"])
    it = _interaction_of(v)
    fr = bxdf_ops.surface_eval(cfg, mat, it, v["ray_in"], out_dir,
                               scene.world_medium.ior[0], mode=mode,
                               scene=scene)
    N = is_mi.shape[0]
    return jnp.where(is_mi[..., None],
                     jnp.broadcast_to(ph[..., None], (N, 3)), fr)


def pdf_vertex(scene, cfg, v, ray_in, out_dir):
    """Solid-angle pdf at v for ray_in->out_dir
    (path_tracer.py:496-506)."""
    is_mi = _is_mi_v(v)
    in_free = _in_fspace(v)
    rows, _ = effective_medium(scene, cfg, v["obj_id"], in_free)
    ph = medium_ops.phase_eval(rows["kind"], rows["ph_par"], rows["ph_pdf"],
                               ray_in, out_dir, _phase_kinds(cfg))
    mat = bxdf_ops.gather_mat(scene, v["obj_id"])
    it = _interaction_of(v)
    sp = bxdf_ops.surface_pdf(cfg, mat, it, out_dir, ray_in,
                              scene.world_medium.ior[0], scene=scene)
    return jnp.where(is_mi, ph, sp)


def _pdf_light(scene, cur, prev_pos, prev_ns, prev_has_n):
    """Emission direction pdf of emitter vertex cur toward prev, in area
    measure at prev (bdpt.py:572-582)."""
    diff = prev_pos - cur["pos"]
    inv_len = 1.0 / jnp.maximum(norm(diff), 1e-9)
    d = diff * inv_len[..., None]
    eid = jnp.maximum(cur["emit_id"], 0)
    kind = scene.emit_kind[eid]
    pdf = jnp.zeros(inv_len.shape, jnp.float32)
    from ..constants import INV_PI, INV_2PI
    pdf = jnp.where(kind == EmitterTag.POINT, INV_PI * 0.25, pdf)
    pdf = jnp.where(kind == EmitterTag.SPOT,
                    INV_2PI / jnp.maximum(1.0 - scene.emit_r[eid], 1e-9),
                    pdf)
    pdf = jnp.where(kind == EmitterTag.AREA,
                    jnp.maximum(dot(d, cur["n_g"]), 0.0) * INV_PI, pdf)
    pdf = jnp.where(prev_has_n, pdf * jnp.abs(dot(d, prev_ns)), pdf)
    return pdf * inv_len * inv_len


def _area_pdf(scene, cfg, emit_id):
    eid = jnp.maximum(emit_id, 0)
    return jnp.where(scene.emit_kind[eid] == EmitterTag.AREA,
                     scene.emit_inv_area[eid], 0.0)


# ------------------------------- random walk --------------------------------

def bdpt_random_walk(scene, cfg, key, buffers, ray_o, ray_d, init_pdf, beta,
                     mode, init_time, max_bnc):
    """Shared subpath walk (reference bdpt.py:204-304). Slot 0 is pre-filled
    by the caller; returns (buffers, vertex_count) with count including
    slot 0."""
    N = ray_o.shape[0]
    world_ior = scene.world_medium.ior[0]
    media_everywhere = cfg.world_scattering or bool(cfg.volume_kind)
    max_time = cfg.t_min + cfg.t_interval * max(cfg.t_bins, 1)

    st = dict(key=key, buf=buffers, ray_o=ray_o, ray_d=ray_d, thp=beta,
              ray_pdf=init_pdf, acc_time=jnp.full((N,), init_time)
              if jnp.ndim(init_time) == 0 else init_time,
              last_pos=ray_o, vnum=jnp.zeros((N,), jnp.int32),
              # shading normal of the last PLACED vertex (slot 0 at entry):
              # carried so the per-iteration pdf_bwd conversion reads no
              # (D, N) buffer plane. Measured device-neutral (cbox 6-bounce
              # op stats byte-identical): XLA already CSEd the one-hot
              # gather of just-written values; kept so correctness doesn't
              # lean on that CSE firing.
              prev_ns=_static_vertex(buffers, 0)["n_s"],
              active=jnp.ones((N,), bool),
              it=ray_intersect(scene, cfg, ray_o, ray_d))

    def iteration(_i, st):
        key = st["key"]
        active = st["active"]
        ray_o, ray_d = st["ray_o"], st["ray_d"]
        thp = st["thp"]
        buf = st["buf"]

        # interaction carried from the previous iteration's next-segment
        # intersect (same restructure as renderer/vpt.py: one closest-hit
        # per iteration)
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

        # statically media-free scenes (no MediumTags, no world scattering,
        # no grid volume) skip mean-free-path sampling entirely: scene
        # tables are runtime inputs, so XLA cannot fold the sampled-
        # exponential math away on its own. The medium ior gather stays
        # (pure-ior media are not in cfg.medium_kinds but scale time).
        no_media = (not cfg.medium_kinds and not cfg.world_scattering
                    and not cfg.volume_kind)
        rows, scat = effective_medium(scene, cfg, obj_id, in_free)
        key, k_mfp = jax.random.split(key)   # keep the key stream aligned
        if no_media:
            is_mi = jnp.zeros((N,), bool)
            mfp = depth
        else:
            u_mfp = jax.random.uniform(k_mfp, (N, 2))
            is_mi, mfp, path_beta = medium_ops.sample_mfp(
                rows["u_e"], rows["u_s"], scat, depth, u_mfp)
        if cfg.volume_kind:
            from ..ops import volume_ops
            key, k_vol = jax.random.split(key)
            v_t, v_beta = volume_ops.sample_distance_delta_tracking(
                scene.volume, cfg.volume_kind, k_vol, ray_o, ray_d, thp,
                depth, active=active)
            is_vol = v_t > 0.0
            mfp = jnp.where(is_vol, v_t, mfp)
            path_beta = jnp.where(is_vol[..., None], v_beta, path_beta)
            is_mi = is_mi | is_vol
        active &= ~(miss & ~is_mi)
        if not no_media:
            thp = thp * jnp.where(active[..., None], path_beta, 1.0)
        active &= jnp.max(thp, -1) >= 5e-5

        hit_point = ray_o + ray_d * mfp[..., None]
        hit_light = jnp.where(is_mi | miss, -1,
                              tgather(scene.obj_emitter,
                                      jnp.maximum(obj_id, 0)))
        ior = jnp.where(in_free, world_ior, rows["ior"])
        acc_time = st["acc_time"] + jnp.where(active, mfp * ior, 0.0)
        if cfg.transient:
            active &= acc_time <= max_time

        is_null = (~is_mi & _is_null_surface(scene, obj_id)
                   if cfg.has_null_bsdf else jnp.zeros((N,), bool))
        place = active & ~is_null

        # pdf_fwd at the new vertex
        pdf_fwd = _convert_density(st["ray_pdf"], hit_point - st["last_pos"],
                                   it.n_s, is_mi)
        is_delta = ~is_mi & tgather(scene.mat_is_delta,
                                    jnp.maximum(obj_id, 0)) \
            & (obj_id >= 0)
        bits = (jnp.where(is_delta, B_DIR_DELTA | B_SPEC_DELTA, 0)
                | jnp.where(hit_light >= 0, B_IS_AREA, 0)
                | jnp.where(in_free, B_IN_FSPACE, 0))

        it = process_ns(scene, cfg, it)
        zero3 = jnp.zeros((N, 3), jnp.float32)
        tex_kw = {}
        it_tex = it
        if scene.tex["albedo"].present:
            tex, _ = get_uv_item(scene, scene.tex["albedo"], it)
            tex_kw = dict(tex=tex)
            it_tex = dataclasses.replace(it, tex=tex)
        vnum = st["vnum"] + jnp.where(place, 1, 0)

        # continuation sampling BEFORE the vertex write so the specular
        # flag folds into the written bits (the former set_d_delta one-hot
        # read-modify-write re-touched the whole (D, N) bits plane)
        mat = bxdf_ops.gather_mat(scene, obj_id)
        key, k_new = jax.random.split(key)
        u_new = jax.random.uniform(k_new, (N, 6))
        s_dir, s_spec, s_pdf, is_specular = bxdf_ops.surface_sample(
            cfg, mat, it_tex, ray_d, u_new, world_ior, mode=mode)
        rows_v = rows
        if cfg.volume_kind:
            vol_kind = jnp.full((N,), cfg.volume_phase, jnp.int32)
            rows_v = dict(rows)
            rows_v["kind"] = jnp.where(is_vol, vol_kind, rows["kind"])
            rows_v["ph_par"] = jnp.where(is_vol[..., None],
                                         scene.volume.ph_par[None, :],
                                         rows["ph_par"])
            rows_v["ph_pdf"] = jnp.where(is_vol[..., None],
                                         scene.volume.ph_pdf[None, :],
                                         rows["ph_pdf"])
        if no_media:                  # is_mi statically all-False
            new_dir, ray_pdf = s_dir, s_pdf
        else:
            p_dir, p_val = medium_ops.phase_sample(
                rows_v["kind"], rows_v["ph_par"], rows_v["ph_pdf"], ray_d,
                u_new[:, :3], _phase_kinds(cfg))
            new_dir = jnp.where(is_mi[..., None], p_dir, s_dir)
            ray_pdf = jnp.where(is_mi, p_val, s_pdf)
            is_specular = ~is_mi & is_specular

        # vertex write, with the specular-delta flag (set_d_delta) already
        # folded into bits — sampling happened above
        bits = bits | jnp.where(is_specular, B_DIR_DELTA | B_SPEC_DELTA, 0)
        vtype_v = jnp.where(is_mi, VERTEX_MEDIUM, VERTEX_SURFACE)
        n_s_v = jnp.where(is_mi[..., None], zero3, it.n_s)
        n_g_v = jnp.where(is_mi[..., None], zero3, it.n_g)
        vals = dict(
            vtype=vtype_v, obj_id=obj_id, emit_id=hit_light, bits=bits,
            pdf_fwd=pdf_fwd, time=acc_time, pos=hit_point,
            n_s=n_s_v, n_g=n_g_v, ray_in=ray_d, beta=thp, **tex_kw)
        if cfg.has_null_bsdf:
            buf = _write_vertex(buf, vnum, place, **vals)
        else:
            # without null BSDFs every placing lane places into slot
            # _i+1 (see _write_vertex_at): one dynamic row per field
            # instead of a (D, N) full-plane one-hot rewrite
            buf = _write_vertex_at(buf, _i + 1, place, **vals)

        walk_on = active & (vnum < max_bnc)

        dead_surface = ~is_mi & ((jnp.max(s_spec, -1) <= 0.0)
                                 | (s_pdf <= 0.0))
        cont = jnp.where(is_mi[..., None], 1.0,
                         s_spec / jnp.maximum(s_pdf, 1e-9)[..., None])
        thp_next = thp * jnp.where(walk_on[..., None], cont, 1.0)
        csn = _correct_shading_normal(it.n_s, it.n_g, ray_d, new_dir, is_mi,
                                      mode)
        thp_next = thp_next * jnp.where(walk_on, csn, 1.0)[..., None]

        # backward pdf of the PREVIOUS vertex (bdpt.py:293-303). The just-
        # written vertex is still in registers — rebuild the dict instead
        # of one-hot-gathering it back out of the (D, N) planes (measured
        # device-neutral: XLA already CSEd that gather; kept explicit so
        # correctness doesn't lean on the CSE). Consumers are masked by
        # `place` so non-placing lanes' junk values are never read
        cur_v = dict(vtype=vtype_v, obj_id=obj_id, emit_id=hit_light,
                     bits=bits, pos=hit_point, n_s=n_s_v, n_g=n_g_v,
                     ray_in=ray_d, tex=tex_kw.get("tex"))
        pdf_bwd_sa = jnp.where(
            is_mi, ray_pdf,
            jnp.where(is_delta, 0.0,
                      pdf_vertex(scene, cfg, cur_v, -new_dir, -ray_d)))
        ray_pdf = jnp.where(is_delta & ~is_mi, 0.0, ray_pdf)
        # previous placed vertex: pos/n_s ride the carry (last_pos/prev_ns)
        prev_ns = st["prev_ns"]
        bwd = _get_pdf_bwd(st["last_pos"], prev_ns,
                           jnp.any(prev_ns != 0.0, axis=-1),
                           pdf_bwd_sa, hit_point)
        if cfg.has_null_bsdf:
            oh_prev = _slot_onehot(buf, vnum - 1, place & walk_on)
            buf["pdf_bwd"] = jnp.where(oh_prev, bwd[None, :],
                                       buf["pdf_bwd"])
        else:                         # previous slot is statically _i
            old = jax.lax.dynamic_index_in_dim(buf["pdf_bwd"], _i, 0,
                                               keepdims=False)
            buf["pdf_bwd"] = jax.lax.dynamic_update_index_in_dim(
                buf["pdf_bwd"], jnp.where(place & walk_on, bwd, old),
                _i, 0)

        active = walk_on & ~(~is_mi & dead_surface)
        # null lanes continue in the same direction without placing
        out_dir = jnp.where(is_null[..., None], ray_d, new_dir)
        # the LAST iteration's next-segment interaction is never consumed
        # (it only feeds the following iteration) — skip the closest-hit
        # sweep there instead of letting it sit un-DCE'd in the carry
        it_n = jax.lax.cond(
            _i < iters - 1,
            lambda: ray_intersect(scene, cfg, hit_point, out_dir,
                                  alive=active),
            lambda: jax.tree_util.tree_map(jnp.zeros_like, st["it"]))

        return dict(key=key, buf=buf, ray_o=hit_point, ray_d=out_dir,
                    thp=thp_next, ray_pdf=ray_pdf, acc_time=acc_time,
                    last_pos=jnp.where(place[..., None], hit_point,
                                       st["last_pos"]),
                    prev_ns=jnp.where(place[..., None], n_s_v,
                                      st["prev_ns"]),
                    vnum=vnum, active=active, it=it_n)

    # Extra iterations are needed only for null-surface crossings (they
    # advance the ray without placing a vertex). Medium interactions
    # PLACE (VERTEX_MEDIUM), so media_everywhere alone cannot starve the
    # budget: with no null BSDF every active iteration places and vnum
    # reaches max_bnc in max_bnc steps — the former
    # `or media_everywhere` term ran 4 provably-inert all-dead
    # iterations per walk on cbox (40% of the walk at 6 bounces).
    iters = max_bnc + (NULL_BUDGET if cfg.has_null_bsdf else 0)
    # unroll 2x to amortize the per-iteration loop overhead, which the two
    # subpath walks pay ~13 times per pass
    u = 2 if iters >= 2 else 1
    base = (iters // u) * u

    def unrolled(i, s):
        for j in range(u):
            s = iteration(i * u + j, s)
        return s

    st = jax.lax.fori_loop(0, iters // u, unrolled, st)
    for j in range(base, iters):                   # static remainder
        st = iteration(j, st)
    return st["buf"], st["vnum"] + 1


def generate_eye_path(scene, cfg, key, cnt, max_bnc, pix_ids=None):
    N = cfg.n_pixels if pix_ids is None else pix_ids.shape[0]
    key, cam_key = jax.random.split(key)
    ray_o, ray_d = camera_rays(scene, cfg, cam_key, cnt, pix_ids=pix_ids)
    buf = _vertex_buffers(N, max_bnc + 1, scene.tex["albedo"].present)
    ones = jnp.ones((N,), bool)
    buf = _write_vertex(
        buf, jnp.zeros((N,), jnp.int32), ones,
        vtype=jnp.full((N,), VERTEX_CAMERA, jnp.int32),
        obj_id=jnp.full((N,), -1, jnp.int32),
        emit_id=jnp.full((N,), -1, jnp.int32),
        bits=jnp.full((N,), B_POS_DELTA | B_IN_FSPACE, jnp.int32),
        pos=jnp.broadcast_to(scene.cam_t, (N, 3)),
        beta=jnp.ones((N, 3), jnp.float32),
        time=jnp.zeros((N,), jnp.float32))
    # pdf_camera is 0 (reference parity), so the walk starts with pdf 0
    dot_ray = dot(ray_d, _cam_normal(scene))
    pdf_dir = pdf_camera(cfg, dot_ray)
    return bdpt_random_walk(scene, cfg, key, buf, ray_o, ray_d, pdf_dir,
                            jnp.ones((N, 3), jnp.float32), TRANSPORT_RAD,
                            0.0, max_bnc)


def generate_light_path(scene, cfg, key, max_bnc, n_paths=None):
    N = cfg.n_pixels if n_paths is None else n_paths
    key, k_pick, k_le = jax.random.split(key, 3)
    u_pick = jax.random.uniform(k_pick, (N,))
    eid, emitter_pdf, _valid = emitter_ops.sample_light_index(
        cfg, u_pick, jnp.full((N,), -1, jnp.int32))
    u_le = jax.random.uniform(k_le, (N, 5))
    ray_o, ray_d, pdf_pos, pdf_dir, normal = emitter_ops.sample_le(
        scene, cfg, eid, u_le)
    intensity = scene.emit_intensity[eid]
    vertex_pdf = pdf_pos * emitter_pdf

    buf = _vertex_buffers(N, max_bnc + 1, scene.tex["albedo"].present)
    ones = jnp.ones((N,), bool)
    buf = _write_vertex(
        buf, jnp.zeros((N,), jnp.int32), ones,
        vtype=jnp.full((N,), VERTEX_EMITTER, jnp.int32),
        obj_id=scene.emit_obj[eid], emit_id=eid,
        bits=scene.emit_bits[eid], pdf_fwd=vertex_pdf,
        time=scene.emit_time[eid], n_s=normal, n_g=normal, pos=ray_o,
        beta=intensity)

    ok = (pdf_dir > 0.0) & (jnp.max(intensity, -1) > 0.0) \
        & (vertex_pdf > 0.0)
    beta = intensity * jnp.abs(dot(ray_d, normal))[..., None] \
        / jnp.maximum(vertex_pdf * pdf_dir, 1e-12)[..., None]
    beta = jnp.where(ok[..., None], beta, 0.0)
    buf, vnum = bdpt_random_walk(scene, cfg, key, buf, ray_o, ray_d, pdf_dir,
                                 beta, TRANSPORT_IMP, scene.emit_time[eid],
                                 max_bnc)
    vnum = jnp.where(ok, vnum, 1)
    return buf, vnum


def generate_paths(scene, cfg, key, cnt, max_bnc, pix_ids=None):
    """Both subpath walks fused into ONE 2N-lane wavefront.

    MEASURED DEAD END — kept for the record, NOT used by bdpt_pass_core:
    fusing eye lanes [:N] and light lanes [N:] into one bounce loop (one
    intersect sweep, one sampling pass, one (D, 2N) vertex write) was
    built on the hypothesis that per-iteration op/launch overhead
    dominated the 50.8 ms the two walks cost in a 133 ms cbox 6-bounce
    pass. scripts/bench_bdpt_phases.py disproved it: fused walks measure
    58.8 ms (+16%) — the walk is bandwidth/compute-bound, so doubling
    lanes only doubles per-iteration bytes while the per-lane `mode`
    selects add work the static-mode walks compile away. Same math as
    generate_eye_path + generate_light_path (reference bdpt.py:204-304).
    Returns (cam_buf, cam_vnum, lit_buf, lit_vnum)."""
    N = cfg.n_pixels if pix_ids is None else pix_ids.shape[0]
    key, cam_key, k_pick, k_le = jax.random.split(key, 4)

    # eye lanes (generate_eye_path setup)
    ray_o_c, ray_d_c = camera_rays(scene, cfg, cam_key, cnt,
                                   pix_ids=pix_ids)
    pdf_dir_c = pdf_camera(cfg, dot(ray_d_c, _cam_normal(scene)))

    # light lanes (generate_light_path setup)
    u_pick = jax.random.uniform(k_pick, (N,))
    eid, emitter_pdf, _valid = emitter_ops.sample_light_index(
        cfg, u_pick, jnp.full((N,), -1, jnp.int32))
    u_le = jax.random.uniform(k_le, (N, 5))
    ray_o_l, ray_d_l, pdf_pos, pdf_dir_l, normal = emitter_ops.sample_le(
        scene, cfg, eid, u_le)
    intensity = scene.emit_intensity[eid]
    vertex_pdf = pdf_pos * emitter_pdf
    ok = (pdf_dir_l > 0.0) & (jnp.max(intensity, -1) > 0.0) \
        & (vertex_pdf > 0.0)
    beta_l = intensity * jnp.abs(dot(ray_d_l, normal))[..., None] \
        / jnp.maximum(vertex_pdf * pdf_dir_l, 1e-12)[..., None]
    beta_l = jnp.where(ok[..., None], beta_l, 0.0)

    cat = partial(jnp.concatenate, axis=0)
    z1 = jnp.zeros((N,), jnp.float32)
    z3 = jnp.zeros((N, 3), jnp.float32)
    zi = jnp.full((N,), -1, jnp.int32)
    buf = _vertex_buffers(2 * N, max_bnc + 1, scene.tex["albedo"].present)
    buf = _write_vertex(
        buf, jnp.zeros((2 * N,), jnp.int32), jnp.ones((2 * N,), bool),
        vtype=cat([jnp.full((N,), VERTEX_CAMERA, jnp.int32),
                   jnp.full((N,), VERTEX_EMITTER, jnp.int32)]),
        obj_id=cat([zi, scene.emit_obj[eid]]),
        emit_id=cat([zi, eid]),
        bits=cat([jnp.full((N,), B_POS_DELTA | B_IN_FSPACE, jnp.int32),
                  scene.emit_bits[eid]]),
        pdf_fwd=cat([z1, vertex_pdf]),
        time=cat([z1, scene.emit_time[eid]]),
        n_s=cat([z3, normal]), n_g=cat([z3, normal]),
        pos=cat([jnp.broadcast_to(scene.cam_t, (N, 3)), ray_o_l]),
        beta=cat([jnp.ones((N, 3), jnp.float32), intensity]))

    mode = cat([jnp.full((N,), TRANSPORT_RAD, jnp.int32),
                jnp.full((N,), TRANSPORT_IMP, jnp.int32)])
    buf, vnum = bdpt_random_walk(
        scene, cfg, key, buf,
        cat([ray_o_c, ray_o_l]), cat([ray_d_c, ray_d_l]),
        cat([pdf_dir_c, pdf_dir_l]),
        cat([jnp.ones((N, 3), jnp.float32), beta_l]), mode,
        cat([z1, scene.emit_time[eid]]), max_bnc)

    cam_buf = {k: (None if v is None else v[..., :N])
               for k, v in buf.items()}
    lit_buf = {k: (None if v is None else v[..., N:])
               for k, v in buf.items()}
    return cam_buf, vnum[:N], lit_buf, jnp.where(ok, vnum[N:], 1)


# ------------------------------- connections --------------------------------

def _null_vertex(N, has_tex):
    """All-null lit_side placeholder for s == 0 strategies. has_tex must
    match _vertex_buffers' static tex-plane presence."""
    z3 = jnp.zeros((N, 3), jnp.float32)
    zi = jnp.full((N,), -1, jnp.int32)
    zf = jnp.zeros((N,), jnp.float32)
    return dict(vtype=zi, obj_id=zi, emit_id=zi, bits=jnp.zeros((N,),
                jnp.int32), pdf_fwd=zf, pdf_bwd=zf, time=zf, n_s=z3,
                n_g=z3, pos=z3, ray_in=z3, beta=z3,
                tex=(z3 if has_tex else None))


def _pdf_ratio(scene, cfg, cur, prev_pos, prev_null, nxt):
    """remap(area-pdf of cur->nxt) / remap(nxt.pdf_fwd)
    (reference bdpt.py:541-570)."""
    ray_out = nxt["pos"] - cur["pos"]
    out_norm = norm(ray_out)
    safe = jnp.maximum(out_norm, 1e-9)
    out_dir = ray_out / safe[..., None]

    is_emitter = cur["vtype"] == VERTEX_EMITTER
    is_camera = cur["vtype"] == VERTEX_CAMERA

    # emitter: directional pdf in area measure at nxt
    pdf_emit = _pdf_light(scene, cur, nxt["pos"], nxt["n_s"],
                          _has_normal(nxt))
    # camera: pdf_camera (reference-faithful 0)
    pdf_cam_sa = pdf_camera(cfg, jnp.abs(dot(_cam_normal(scene), out_dir)))
    # generic surface/medium vertex
    ray_in = jnp.where(prev_null[..., None], jnp.zeros_like(out_dir),
                       normalize(cur["pos"] - prev_pos))
    pdf_sa = pdf_vertex(scene, cfg, cur, ray_in, out_dir)
    pdf_sa = jnp.where(is_camera, pdf_cam_sa, pdf_sa)
    pdf_sa = jnp.where(out_norm > 0.0, pdf_sa, 0.0)

    pdf_area = _get_pdf_bwd(nxt["pos"], nxt["n_s"], _has_normal(nxt),
                            pdf_sa, cur["pos"])
    pdf_area = jnp.where(is_emitter, pdf_emit, pdf_area)
    return _remap(pdf_area) / _remap(nxt["pdf_fwd"])


def _mis_planes(cam_buf, lit_buf):
    """Strategy-independent (D, N) planes for the vectorized MIS sweeps:
    per-slot pdf ratios remap(pdf_bwd)/remap(pdf_fwd) and not-delta
    flags, for each subpath buffer. Computed once per pass and closed
    over by the strategy scans (they depend only on the walked buffers,
    not on (s, t))."""
    def per(buf):
        return (_remap(buf["pdf_bwd"]) / _remap(buf["pdf_fwd"]),
                (buf["bits"] & B_SPEC_DELTA) == 0)
    return per(cam_buf) + per(lit_buf)


def _vertex_at(buf, idx):
    """Vertex slot read: static row slice for a python-int index, dense
    dynamic row slice for a traced scalar (never a per-lane gather)."""
    if isinstance(idx, int):
        return _static_vertex(buf, max(idx, 0))
    return _dyn_vertex(buf, jnp.maximum(idx, 0))


def _stack_rows(rows_st, build):
    """Concatenate per-row vertex dicts along the lane axis (K*N,)."""
    parts = [build(si, ti) for (si, ti) in rows_st]
    if len(parts) == 1:
        return parts[0]
    return {k: (None if v is None
                else jnp.concatenate([p[k] for p in parts], axis=0))
            for k, v in parts[0].items()}


def _mis_weight(scene, cfg, cam_buf, lit_buf, cam_side, lit_side, s, t,
                case=None, planes=None, rows=None):
    """Iterative MIS ratio sweep (reference bdpt.py:412-491).

    Two batching modes share this one implementation:
    - rows=None (single strategy): s, t may be traced scalars; sides are
      (N,) dicts. `case` resolves every structural branch so ONE traced
      body serves every (s, t) of a case under a lax.scan.
    - rows=[(s, t), ...] (flat mode): all indices STATIC python ints;
      sides are the K strategies' vertices concatenated to (K*N,) lane
      dicts. The endpoint-ratio math (the expensive part: two to four
      pdf_vertex dispatches) then runs ONCE over K*N lanes instead of K
      times over N, and the per-row sweeps fold their masks statically.

    The ratio sweeps are VECTORIZED masked suffix-products over the
    depth axis of the (D, N) pdf planes (same recurrence the reference
    iterates per path): the former masked fori_loops issued one tiny
    while-iteration per depth step per strategy (~460 per pass) on cbox
    6-bounce. Compile cost stays O(1) in max_bounce for the scan mode,
    O(K) cheap row slices for the flat mode."""
    if rows is None:
        if case is None:
            case = _strategy_case(int(s), int(t))
        rows_st = [(s, t)]
    else:
        rows_st = [(r[0], r[1]) for r in rows]
    if planes is None:
        planes = _mis_planes(cam_buf, lit_buf)
    cam_steps, cam_nd, lit_steps, lit_nd = planes
    NF = cam_side["vtype"].shape[0]            # K*N flat lanes
    N = cam_buf["vtype"].shape[1]
    K = len(rows_st)
    D = cam_buf["vtype"].shape[0]
    sum_terms = []
    false_n = jnp.zeros((NF,), bool)

    # previous-vertex rows, stacked to match the flat sides
    cam_prev_f = _stack_rows(rows_st,
                             lambda si, ti: _vertex_at(cam_buf, ti - 2))
    if case not in ("s0", "s1"):
        lit_prev_f = _stack_rows(rows_st,
                                 lambda si, ti: _vertex_at(lit_buf, si - 2))

    # endpoint ratio overrides (update_endpoint, bdpt.py:412-428)
    r_cam_end = jnp.ones((NF,), jnp.float32)   # ratios[0] cam sweep seed
    r_cam_prev = jnp.full((NF,), -1.0)         # ratios[1]
    r_lit_end = jnp.ones((NF,), jnp.float32)   # ratios[2] lit sweep seed
    r_lit_prev = jnp.full((NF,), -1.0)         # ratios[3]

    if case != "s0":
        if case == "t1":                       # idx_t < 1
            prev_pos = jnp.zeros((NF, 3), jnp.float32)
            prev_null = jnp.ones((NF,), bool)
        else:
            prev_pos = cam_prev_f["pos"]
            prev_null = false_n
        r_lit_end = _pdf_ratio(scene, cfg, cam_side, prev_pos, prev_null,
                               lit_side)
        if case != "t1":                       # idx_t >= 1
            r_cam_prev = _pdf_ratio(scene, cfg, cam_side, lit_side["pos"],
                                    false_n, cam_prev_f)
        if case == "s1":                       # idx_s < 1
            prev_pos = jnp.zeros((NF, 3), jnp.float32)
            prev_null = jnp.ones((NF,), bool)
        else:
            prev_pos = lit_prev_f["pos"]
            prev_null = false_n
        r_cam_end = _pdf_ratio(scene, cfg, lit_side, prev_pos, prev_null,
                               cam_side)
        if case != "s1":                       # idx_s >= 1
            r_lit_prev = _pdf_ratio(scene, cfg, lit_side, cam_side["pos"],
                                    false_n, lit_prev_f)
    else:
        # camera path hit an emitter (s == 0, bdpt.py:424-428)
        r_cam_end = _remap(_area_pdf(scene, cfg, cam_side["emit_id"])
                           / float(max(cfg.n_emitters, 1))) \
            / _remap(cam_side["pdf_fwd"])
        # s0 strategies have t >= 2, so idx_t >= 1 always
        r_cam_prev = _remap(_pdf_light(scene, cam_side, cam_prev_f["pos"],
                                       cam_prev_f["n_s"],
                                       _has_normal(cam_prev_f))) \
            / _remap(cam_prev_f["pdf_fwd"])

    iota = jnp.arange(D)[:, None]              # (D, 1) slot index
    if case != "t1":
        nd_prev_cam = _not_delta(cam_prev_f)   # (NF,) nd at idx_t-1
    if case != "s0":
        lit0_nd = _not_delta_source(_static_vertex(lit_buf, 0))   # (N,)
        lit_prev_nd_full = jnp.concatenate(
            [lit0_nd[None, :], lit_nd[:-1]], axis=0)
        cur_nd_f = lit0_nd if case == "s1" else _not_delta(lit_prev_f)
    cam_prev_nd_full = jnp.concatenate([cam_nd[:1], cam_nd[:-1]], axis=0)

    def sweep_table(steps, gates):
        """Shared sweep prefix table B (D, N).

        The per-strategy sweep Σ_{k<=hi} g_k Π_{m=k..hi} s'_m (s' =
        steps with the endpoint override at m == hi) factors as
        r_eff * B[hi] where B[h] = A(h-1) + g_h and A obeys the affine
        recurrence A_h = s_h A_{h-1} + s_h g_h — ONE associative scan
        serves every strategy row. The former per-row masked suffix
        cumprods (2 flips + cumprod + gated (D, N) reduce per row per
        side) were the MIS cost center: rev alone measured 8.6 ms/pass,
        the gated reduce 9.5 (chain5 xprof). Same math, same recurrence
        as the reference's per-path ri loop (bdpt.py:452-489); float
        association differs (tree order), ~1 ulp per factor."""
        g = gates.astype(jnp.float32)

        def comb(x, y):
            a1, b1 = x
            a2, b2 = y
            return a1 * a2, b1 * a2 + b2

        _, A = jax.lax.associative_scan(comb, (steps, steps * g), axis=0)
        return jnp.concatenate(
            [jnp.zeros((1, N), jnp.float32), A[:-1]], axis=0) + g

    B_cam = B_lit = None
    if case != "t1":
        B_cam = sweep_table(cam_steps,
                            cam_nd & cam_prev_nd_full & (iota >= 1))
    if case != "s0":
        B_lit = sweep_table(lit_steps, lit_nd & lit_prev_nd_full)

    def row_at(plane, idx):
        """(D, N) -> (N,) row: static slice for python ints, dense
        dynamic row slice for traced scalars (never a per-lane gather)."""
        if isinstance(idx, int):
            return plane[idx]
        return jax.lax.dynamic_slice_in_dim(
            plane, jnp.maximum(idx, 0), 1, 0)[0]

    def seg(x, i):
        # row-shared (N,) arrays (e.g. the s1 light-origin flags) pass
        # through; flat (K*N,) arrays are sliced to row i's lanes
        if K == 1 or x.shape[0] == N:
            return x
        return jax.lax.slice_in_dim(x, i * N, (i + 1) * N)

    for i, (si, ti) in enumerate(rows_st):
        idx_t = ti - 1
        idx_s = si - 1
        sum_ri = jnp.zeros((N,), jnp.float32)

        # camera-side sweep (bdpt.py:452-467): terms k = idx_t-1 .. 1,
        # each r_cam_end * prod_{m=k}^{idx_t-1} step_m gated by
        # not_delta(v_k) & not_delta(v_{k-1})
        if case != "t1":                       # idx_t > 0, so hi >= 0
            rce = seg(r_cam_end, i)
            sum_ri = sum_ri + jnp.where(seg(nd_prev_cam, i), rce, 0.0)
            hi = idx_t - 1
            rp = seg(r_cam_prev, i)
            r_eff = jnp.where(rp > 0.0, rp, row_at(cam_steps, hi))
            sum_ri = sum_ri + rce * r_eff * row_at(B_cam, hi)

        # light-side sweep (bdpt.py:468-489): terms k = idx_s-1 .. 0;
        # the k == 0 gate uses the source-delta flags of the light origin
        if case != "s0":                       # idx_s >= 0
            rle = seg(r_lit_end, i)
            sum_ri = sum_ri + jnp.where(seg(cur_nd_f, i), rle, 0.0)
            hi = idx_s - 1
            if not (isinstance(hi, int) and hi < 0):   # s == 1: empty
                rp = seg(r_lit_prev, i)
                r_eff = jnp.where(rp > 0.0, rp, row_at(lit_steps, hi))
                sweep = r_eff * row_at(B_lit, hi)
                if not isinstance(hi, int):            # traced s may be 1
                    sweep = jnp.where(hi >= 0, sweep, 0.0)
                sum_ri = sum_ri + rle * sweep
        sum_terms.append(sum_ri)

    total = sum_terms[0] if K == 1 else jnp.concatenate(sum_terms, axis=0)
    return 1.0 / (1.0 + total)


def connect_strategy(scene, cfg, key, cam_buf, cam_vnum, lit_buf, lit_vnum,
                     s, t, case=None, planes=None, rows=None):
    """One (t, s) strategy — or a FLAT BATCH of them — over the whole
    wavefront (reference bdpt.py:306-410). Returns (radiance (K*N,3),
    raster flat index (K*N,) or -1 for local, path_time (K*N,)).

    rows=None: s, t may be traced scalars; `case` (see _strategy_case)
    is the static connection-case tag — bdpt_pass_core scans a (s,t)
    table per case, so each case's body is traced exactly once
    regardless of max_bounce. `key` is the strategy's folded sub-key.

    rows=[(s, t, k_idx), ...] (all static ints, one shared `case`):
    the K strategies' endpoint vertices are concatenated to (K*N,) lane
    dicts and the whole connection — eval_vertex dispatches, geometry,
    track_ray visibility, MIS endpoint ratios — runs ONCE over K*N
    lanes. Per-strategy scan steps ran the same chains K times over N
    lanes and paid per-fusion overhead each time. `key` is the group
    base key (k_con); per-row RNG folds k_idx exactly as the scan did,
    so sampled endpoints (s1) keep their per-strategy streams."""
    if case is None:
        case = _strategy_case(int(s), int(t))
    N = cam_vnum.shape[0]
    K = 1 if rows is None else len(rows)
    NF = K * N
    world_ior = scene.world_medium.ior[0]
    zero3 = jnp.zeros((NF, 3), jnp.float32)
    if rows is None:
        s = jnp.asarray(s, jnp.int32)
        t = jnp.asarray(t, jnp.int32)
        rows_st = [(s, t)]
    else:
        rows_st = [(r[0], r[1]) for r in rows]

    def flat(build):
        """Concatenate per-row (N,) lane arrays to (K*N,)."""
        parts = [build(si, ti) for (si, ti) in rows_st]
        return parts[0] if K == 1 else jnp.concatenate(parts, axis=0)

    # per-lane strategy bounds (bdpt.py:146-152: t < min(cam_vnum, t_end)
    # with cam_vnum = total vertices + 1)
    valid = flat(lambda si, ti: (ti <= cam_vnum) & (si <= lit_vnum))
    cam_side = _stack_rows(rows_st,
                           lambda si, ti: _vertex_at(cam_buf, ti - 1))
    # multi light connection skip (bdpt.py:153-155)
    if case in ("s1", "gen"):                  # t > 1 and s > 0
        valid &= cam_side["vtype"] != VERTEX_EMITTER

    le = zero3
    raster = jnp.full((NF,), -1, jnp.int32)
    path_time = jnp.zeros((NF,), jnp.float32)
    calc_tr = jnp.zeros((NF,), bool)
    track_pos = zero3
    conn_dir = zero3
    depth = jnp.zeros((NF,), jnp.float32)
    lit_side = (_null_vertex(NF, scene.tex["albedo"].present)
                if case == "s0"
                else _stack_rows(rows_st,
                                 lambda si, ti: _vertex_at(lit_buf,
                                                           si - 1)))

    if case == "s0":
        v = cam_side
        is_l = _is_light_v(v) & (v["emit_id"] >= 0)
        eid = jnp.maximum(v["emit_id"], 0)
        e_le = emitter_ops.eval_le(scene, eid, v["ray_in"], v["n_g"])
        le = jnp.where((valid & is_l)[..., None], e_le * v["beta"], zero3)
        path_time = scene.emit_time[eid] + v["time"]
    elif case == "t1":
        v = lit_side
        ok = valid & _is_connectible(v)
        diff = jnp.broadcast_to(scene.cam_t, (NF, 3)) - v["pos"]
        depth = norm(diff)
        conn_dir = diff / jnp.maximum(depth[..., None], 1e-9)
        we, cam_pdf, pi, pj = sample_camera(scene, cfg, -conn_dir, depth)
        ok &= cam_pdf > 0.0
        fr2cam = eval_vertex(scene, cfg, v, conn_dir, TRANSPORT_IMP)
        cam_beta = (we / jnp.maximum(cam_pdf, 1e-9))[..., None]
        le = jnp.where(ok[..., None], v["beta"] * fr2cam * cam_beta, zero3)
        calc_tr = ok & (jnp.max(fr2cam, -1) > 0.0)
        track_pos = v["pos"]
        raster = jnp.where(ok, pi * cfg.h + pj, -1)
        path_time = v["time"] + depth
        # sampled camera vertex for MIS
        cam_side = _null_vertex(NF, scene.tex["albedo"].present)
        cam_side["vtype"] = jnp.full((NF,), VERTEX_CAMERA, jnp.int32)
        cam_side["bits"] = jnp.full((NF,), B_POS_DELTA | B_IN_FSPACE,
                                    jnp.int32)
        cam_side["pos"] = jnp.broadcast_to(scene.cam_t, (NF, 3))
        cn = _cam_normal(scene)
        cam_side["n_s"] = jnp.broadcast_to(cn, (NF, 3))
        cam_side["n_g"] = jnp.broadcast_to(cn, (NF, 3))
        cam_side["time"] = v["time"] + depth
        cam_side["beta"] = cam_beta * jnp.ones((NF, 3))
    elif case == "s1":
        v = cam_side
        ok = valid & _is_connectible(v)
        if rows is None:
            key, k_pick, k_hit = jax.random.split(key, 3)
            u_pick = jax.random.uniform(k_pick, (N,))
            u_hit = jax.random.uniform(k_hit, (N, 3))
        else:
            # per-row sub-keys fold k_idx off the group base key exactly
            # as the scan body did, so each strategy keeps its stream
            picks = [jax.random.split(jax.random.fold_in(key, kk), 3)
                     for (_si, _ti, kk) in rows]
            u_pick = jnp.concatenate(
                [jax.random.uniform(p[1], (N,)) for p in picks])
            u_hit = jnp.concatenate(
                [jax.random.uniform(p[2], (N, 3)) for p in picks])
        eid, emitter_pdf, e_valid = emitter_ops.sample_light_index(
            cfg, u_pick, jnp.full((NF,), -1, jnp.int32))
        emit_pos, emit_int, _pdf, e_normal = emitter_ops.sample_hit(
            scene, cfg, eid, v["pos"], u_hit)
        diff = emit_pos - v["pos"]
        depth = norm(diff)
        conn_dir = diff / jnp.maximum(depth[..., None], 1e-9)
        ok &= jnp.max(emit_int, -1) > 0.0
        fr2lit = eval_vertex(scene, cfg, v, conn_dir, TRANSPORT_RAD)
        lit_beta = emit_int / jnp.maximum(emitter_pdf, 1e-9)[..., None]
        le = jnp.where(ok[..., None], v["beta"] * fr2lit * lit_beta, zero3)
        calc_tr = ok & (jnp.max(fr2lit, -1) > 0.0)
        track_pos = v["pos"]
        path_time = scene.emit_time[eid] + v["time"]
        # sampled emitter vertex for MIS
        lit_side = _null_vertex(NF, scene.tex["albedo"].present)
        lit_side["vtype"] = jnp.full((NF,), VERTEX_EMITTER, jnp.int32)
        lit_side["obj_id"] = scene.emit_obj[eid]
        lit_side["emit_id"] = eid
        lit_side["bits"] = scene.emit_bits[eid]
        lit_side["time"] = scene.emit_time[eid]
        lit_side["pdf_fwd"] = _area_pdf(scene, cfg, eid) \
            / float(max(cfg.n_emitters, 1))
        lit_side["n_s"] = e_normal
        lit_side["n_g"] = e_normal
        lit_side["pos"] = emit_pos
        lit_side["beta"] = lit_beta
    else:
        cv, lv = cam_side, lit_side
        ok = valid & _is_connectible(cv) & _is_connectible(lv)
        diff = lv["pos"] - cv["pos"]
        depth = norm(diff)
        conn_dir = diff / jnp.maximum(depth[..., None], 1e-9)
        ok &= depth > 0.0
        fr_cam = eval_vertex(scene, cfg, cv, conn_dir, TRANSPORT_RAD)
        fr_lit = eval_vertex(scene, cfg, lv, -conn_dir, TRANSPORT_IMP)
        inv_d2 = 1.0 / jnp.maximum(depth * depth, 1e-12)
        le = jnp.where(ok[..., None],
                       cv["beta"] * fr_cam * fr_lit * lv["beta"]
                       * inv_d2[..., None], zero3)
        calc_tr = ok & (jnp.max(fr_cam, -1) > 0.0) \
            & (jnp.max(fr_lit, -1) > 0.0)
        track_pos = cv["pos"]
        path_time = lv["time"] + cv["time"]

    # transmittance + propagation time (bdpt.py:394-397)
    need_tr = calc_tr & (jnp.max(le, -1) > 0.0)
    if case != "s0":
        if rows is None:
            key, k_tr = jax.random.split(key)
        else:
            # distinct stream off the group base key (k_idx folds are
            # small positive ints, so 1<<31 cannot collide with a row's
            # sub-key)
            k_tr = jax.random.fold_in(key, 1 << 31)
        tr, track_depth = track_ray(scene, cfg, track_pos, conn_dir, depth,
                                    key=k_tr, thp=jnp.ones((NF, 3)),
                                    active=need_tr)
        le = jnp.where(need_tr[..., None], le * tr, le)
        path_time = path_time + jnp.where(need_tr, track_depth, 0.0)

    # MIS weight (bdpt.py:398-404); s+t==2 (the one-bounce "camera sees the
    # emitter" strategy, only reachable in the s0 case) always weights 1
    if cfg.use_mis:
        w = _mis_weight(scene, cfg, cam_buf, lit_buf, cam_side, lit_side,
                        s, t, case=case, planes=planes,
                        rows=None if rows is None else rows_st)
        if case == "s0":
            if rows is None:
                w = jnp.where(s + t == 2, 1.0, w)
            else:
                one = flat(lambda si, ti: jnp.full(
                    (N,), si + ti == 2, bool))
                w = jnp.where(one, 1.0, w)
    else:
        w = jnp.ones((NF,), jnp.float32)
    has_le = jnp.max(le, -1) > 0.0
    result = jnp.where(has_le[..., None], le * w[..., None], zero3)
    if cfg.modulated:
        # AMCW sine-squared ToF modulation (reference bdpt.py:407-408)
        result = result * (0.5 * (jnp.sin(6.0 * path_time)
                                  + 1.0))[..., None] ** 2.0
    result = jnp.nan_to_num(result, nan=0.0, posinf=0.0, neginf=0.0)
    path_time = jnp.where(jnp.max(result, -1) > 0.0, path_time, 0.0)
    # camera first-leg time, for TRUE unwarped binning (cfg.unwarp): the
    # t=1 camera connection IS the leg; every other case has t >= 2 so
    # the eye buffer's slot-1 time is the leg (invalid lanes are masked
    # by in_range's radiance > 0 before the offset is ever used)
    if case == "t1":
        warp_off = depth
    else:
        t1v = cam_buf["time"][1]
        warp_off = flat(lambda si, ti: t1v)
    return result, raster, path_time, warp_off


def bdpt_pass_core(scene, cfg, key, cnt, pix_ids=None, crop_local=False):
    """One BDPT pass, optionally restricted to a pixel shard.

    pix_ids None: full frame. Otherwise only the given pixels' camera
    subpaths (and that many light subpaths) are traced, but t==1 light-
    tracing splats still target the FULL film — multi-chip callers psum
    the splat plane over the pixel axis (the wavefront analog of the
    reference's cross-pixel atomic +=, bdpt.py:159-162).

    crop_local=True asserts pix_ids is exactly the crop-window rectangle
    (renderer/base.py crop_pix_ids order): transient histograms are then
    crop-local, with t==1 raster targets mapped full-film -> crop index
    arithmetically (the reference's crop-aware field layout,
    bdpt.py:49-78).

    Returns (color_local (N,3), color_splat (n_pixels,3), bins, cnts)."""
    full = pix_ids is None
    N = cfg.n_pixels if full else pix_ids.shape[0]
    assert full or crop_local or not cfg.transient, \
        "transient BDPT shards must be the crop window"
    # full-frame cap 32, crop-window cap 400 (reference bdpt.py:29-30
    # N_MAX_BOUNCE / T_MAX_BOUNCE: cropping exists precisely to make deep
    # transient paths affordable — buffers scale with crop pixels)
    cap = CAP_CROP if crop_local else CAP
    max_bnc = min(cfg.max_bounce, cap)
    if cfg.max_bounce > cap:
        import warnings
        warnings.warn(
            f"BDPT subpath depth clamped: scene max_bounce="
            f"{cfg.max_bounce} exceeds the compiled cap {cap} "
            f"(reference N_MAX_BOUNCE=32/T_MAX_BOUNCE=400); "
            f"rendering with {cap} bounces", stacklevel=2)
    key, k_cam, k_lit, k_con = jax.random.split(key, 4)
    cam_buf, cam_vnum = generate_eye_path(scene, cfg, k_cam, cnt, max_bnc,
                                          pix_ids=pix_ids)
    lit_buf, lit_vnum = generate_light_path(scene, cfg, k_lit, max_bnc,
                                            n_paths=N)

    color_local = jnp.zeros((N, 3), jnp.float32)
    color_splat = jnp.zeros((cfg.n_pixels, 3), jnp.float32)
    drop = cfg.n_pixels
    # strategy-independent MIS planes, hoisted out of the strategy scans
    # (XLA does not move loop-invariant plane math out of scan bodies)
    mis_planes = _mis_planes(cam_buf, lit_buf) if cfg.use_mis else None
    if cfg.transient:
        bins = jnp.zeros((N, cfg.t_bins, 3), jnp.float32)
        cnts = jnp.zeros((N, cfg.t_bins), jnp.int32)
    else:                                   # scan carries need arrays
        bins = jnp.zeros((0,), jnp.float32)
        cnts = jnp.zeros((0,), jnp.int32)

    # Enumerate strategies on the host (same order/RNG stream as the
    # reference's double loop, bdpt.py:143-167), but GROUP them by static
    # connection case and lax.scan each group's (s,t,key) table through one
    # traced connect_strategy body. Compile cost is 4 small graphs
    # regardless of max_bounce; the old fully-unrolled form did not finish
    # compiling within 10 minutes at max_bounce=20.
    t_hi = min(cfg.end_t - 1, max_bnc + 1)
    s_hi = min(cfg.end_s - 1, max_bnc + 1)
    groups = {"s0": [], "t1": [], "s1": [], "gen": []}
    k_idx = 0
    for t in range(max(cfg.start_t, 1), t_hi + 1):
        for s in range(max(cfg.start_s, 0), s_hi + 1):
            depth = s + t - 2
            if (s == 1 and t == 1) or depth < 0 or depth > cfg.max_bounce:
                continue
            k_idx += 1
            groups[_strategy_case(s, t)].append((s, t, k_idx))

    def accum_transient(bins, cnts, case, radiance, raster, p_time,
                        n_rows, warp_off=None):
        """Shared transient binning for the scan (n_rows=1, (N,) lanes)
        and flat (n_rows=K, (K*N,) lanes) paths. cfg.unwarp subtracts
        the camera first-leg time (TRUE unwarped decomposition — the
        reference declares transient_lit but coerces it to warped,
        bdpt.py:42-46)."""
        if cfg.unwarp and warp_off is not None:
            p_time = jnp.maximum(p_time - warp_off, 0.0)
        tid = jnp.floor((p_time - cfg.t_min)
                        / cfg.t_interval).astype(jnp.int32)
        in_range = (p_time > cfg.t_min) & (
            p_time < cfg.t_min + cfg.t_interval * cfg.t_bins) \
            & (jnp.max(radiance, -1) > 0.0)
        if case == "t1":
            if full:
                target = jnp.where(raster >= 0, raster, drop)
            else:
                # full-film raster -> crop-local bin index (raster >= 0
                # implies inside the crop window, _rasterize_pinhole)
                ch_ = cfg.end_y - cfg.start_y
                pi = raster // cfg.h
                pj = raster % cfg.h
                loc = (pi - cfg.start_x) * ch_ + (pj - cfg.start_y)
                target = jnp.where(raster >= 0, loc, drop)
        else:
            target = jnp.tile(jnp.arange(N), n_rows)
        target = jnp.where(in_range, target, drop)
        tid = jnp.clip(tid, 0, cfg.t_bins - 1)
        bins = bins.at[target, tid].add(
            jnp.where(in_range[..., None], radiance, 0.0), mode="drop")
        cnts = cnts.at[target, tid].add(
            jnp.where(in_range, 1, 0), mode="drop")
        return bins, cnts

    def run_group_flat(case, table, carry):
        color_local, color_splat, bins, cnts = carry
        Q = max(1, FLAT_LANES // max(N, 1))
        ii_all, rr_all = [], []
        for c0 in range(0, len(table), Q):
            rows = table[c0:c0 + Q]
            radiance, raster, p_time, warp_off = connect_strategy(
                scene, cfg, k_con, cam_buf, cam_vnum, lit_buf, lit_vnum,
                0, 0, case=case, planes=mis_planes, rows=rows)
            if case == "t1":
                ok = raster >= 0
                ii_all.append(jnp.where(ok, raster, drop))
                rr_all.append(jnp.where(ok[..., None], radiance, 0.0))
            else:
                color_local = color_local + jnp.sum(
                    radiance.reshape(len(rows), N, 3), axis=0)
            if cfg.transient:
                bins, cnts = accum_transient(bins, cnts, case, radiance,
                                             raster, p_time, len(rows),
                                             warp_off)
        if case == "t1":
            color_splat = splat_sorted(color_splat,
                                       jnp.concatenate(ii_all),
                                       jnp.concatenate(rr_all, axis=0))
        return (color_local, color_splat, bins, cnts)

    def run_group(case, table, carry):
        Q = max(1, FLAT_LANES // max(N, 1))
        if -(-len(table) // Q) <= FLAT_MAX_CHUNKS:
            return run_group_flat(case, table, carry)

        def body(carry, row):
            color_local, color_splat, bins, cnts = carry
            s_i, t_i, k_i = row[0], row[1], row[2]
            sub = jax.random.fold_in(k_con, k_i)
            radiance, raster, p_time, warp_off = connect_strategy(
                scene, cfg, sub, cam_buf, cam_vnum, lit_buf, lit_vnum,
                s_i, t_i, case=case, planes=mis_planes)
            splat_out = ()
            if case == "t1":
                # defer the film scatter: stack (idx, rgb) per step, one
                # sorted scatter after the scan (see splat_sorted)
                ok = raster >= 0
                splat_out = (jnp.where(ok, raster, drop),
                             jnp.where(ok[..., None], radiance, 0.0))
            else:
                color_local = color_local + radiance
            if cfg.transient:
                bins, cnts = accum_transient(bins, cnts, case, radiance,
                                             raster, p_time, 1, warp_off)
            return (color_local, color_splat, bins, cnts), splat_out

        carry, stacked = jax.lax.scan(body, carry,
                                      jnp.asarray(table, jnp.int32))
        if case == "t1":
            color_local, color_splat, bins, cnts = carry
            idx, rgb = stacked                     # (K, N) / (K, N, 3)
            color_splat = splat_sorted(color_splat, idx.reshape(-1),
                                       rgb.reshape(-1, 3))
            carry = (color_local, color_splat, bins, cnts)
        return carry

    carry = (color_local, color_splat, bins, cnts)
    for case in ("s0", "t1", "s1", "gen"):
        if groups[case]:
            carry = run_group(case, groups[case], carry)
    color_local, color_splat, bins, cnts = carry
    if not cfg.transient:
        bins = cnts = None
    return color_local, color_splat, bins, cnts


@partial(jax.jit, static_argnames=("cfg",))
def render_pass_bdpt(scene, cfg, key, cnt):
    """One full BDPT pass; returns (color (N,3), bins, cnts) where bins/cnts
    are transient histograms (or None, None for steady state; crop-local
    when a crop window is configured).

    With a crop window, ONLY crop pixels are traced (reference
    tracer_base.py:39-55 — that is the point of cropping: it makes deep
    transient runs affordable); light-tracing splats are crop-clipped by
    _rasterize_pinhole exactly as in the reference."""
    from .base import crop_pix_ids
    pix = crop_pix_ids(cfg)
    if pix is None:
        color_local, color_splat, bins, cnts = bdpt_pass_core(
            scene, cfg, key, cnt)
        return color_local + color_splat, bins, cnts
    color_local, color_splat, bins, cnts = bdpt_pass_core(
        scene, cfg, key, cnt, pix_ids=pix, crop_local=True)
    color = color_splat.at[pix].add(color_local)
    return color, bins, cnts


@partial(jax.jit, static_argnames=("cfg", "spp"))
def render_batch_bdpt(scene, cfg, key, cnt0, spp):
    """spp steady-state BDPT passes in one dispatch (transient scenes use
    the per-pass path so time bins accumulate on the host)."""
    N = cfg.n_pixels

    def body(i, acc):
        sub = jax.random.fold_in(key, i)
        color, _b, _c = render_pass_bdpt(scene, cfg, sub, cnt0 + i)
        return acc + jnp.nan_to_num(color, nan=0.0)

    return jax.lax.fori_loop(0, spp, body, jnp.zeros((N, 3), jnp.float32))


_TRANSIENT_KEYS = ("t_min", "t_interval", "sol", "decomposition", "t_bins")


def transient_check_point(cfg, time_bins, time_cnts) -> dict:
    """Transient additions to a checkpoint dict: histograms + the binning
    config they were accumulated under. Shared by BDPT and
    MultiChipRenderer so the schema can't drift between them."""
    import numpy as np
    chk = {k: getattr(cfg, k) for k in _TRANSIENT_KEYS}
    chk["time_bins"] = np.asarray(time_bins)
    chk["time_cnts"] = np.asarray(time_cnts)
    return chk


def validate_transient_check_point(cfg, chk, bins_shape, cnts_shape,
                                   is_transient):
    """Validate (WITHOUT mutating anything) that a checkpoint's transient
    payload matches this run; returns (bins, cnts) to adopt, or
    (None, None) for steady-state runs. Raises on: transient run loading
    a steady checkpoint, steady run loading a transient checkpoint (the
    histograms would be silently dropped), any binning-config mismatch
    (different time axes must not merge), and shape mismatches."""
    has = "time_bins" in chk
    if not is_transient:
        if has:
            raise ValueError(
                "checkpoint carries transient histograms but this run is "
                "steady-state — resuming would silently discard them")
        return None, None
    if not has:
        raise ValueError(
            "checkpoint has no transient histograms (saved from a "
            "steady-state run?)")
    if "time_cnts" not in chk:
        raise ValueError("checkpoint is missing 'time_cnts'")
    for k in _TRANSIENT_KEYS:
        if k in chk and chk[k] != getattr(cfg, k):
            raise ValueError(
                f"transient config mismatch on '{k}': "
                f"{chk[k]} != {getattr(cfg, k)}")
    bins = jnp.asarray(chk["time_bins"])
    cnts = jnp.asarray(chk["time_cnts"])
    if bins.shape != bins_shape or cnts.shape != cnts_shape:
        raise ValueError(
            f"transient histogram shape mismatch: checkpoint "
            f"{bins.shape}/{cnts.shape} != configured "
            f"{bins_shape}/{cnts_shape}")
    return bins, cnts


def transient_copy_average(cfg, time_bins, time_cnts, pix_ids, time_idx):
    """One time bin as a (w,h,3) frame (reference bdpt.py:123-127);
    crop-local bins scatter into a zero full-film frame. Shared by the
    single-chip BDPT and MultiChipRenderer so the export format can't
    drift between them."""
    cnt = jnp.maximum(time_cnts[:, time_idx], 1)
    frame = time_bins[:, time_idx] / cnt[..., None]
    if pix_ids is not None:
        frame = jnp.zeros((cfg.n_pixels, 3),
                          jnp.float32).at[pix_ids].set(frame)
    return frame.reshape(cfg.w, cfg.h, 3)


def transient_frames_np(cfg, time_bins, time_cnts, pix_ids):
    """All time bins as (T, h, w, 3) image-oriented numpy."""
    import numpy as np
    out = []
    for i in range(cfg.t_bins):
        f = transient_copy_average(cfg, time_bins, time_cnts, pix_ids, i)
        out.append(np.asarray(jnp.swapaxes(f, 0, 1))[::-1])
    return np.stack(out)


class BDPT(ProgressiveRenderer):
    """Bidirectional path tracer final class (reference bdpt.py:34)."""

    def __init__(self, scene, cfg, seed: int = 0):
        super().__init__(scene, cfg, seed)
        self.is_transient = cfg.transient
        if self.is_transient:
            from .base import crop_pix_ids
            self._pix_ids = crop_pix_ids(cfg)
            n_traced = cfg.n_pixels if self._pix_ids is None \
                else int(self._pix_ids.shape[0])
            self.time_bins = jnp.zeros((n_traced, cfg.t_bins, 3),
                                       jnp.float32)
            self.time_cnts = jnp.zeros((n_traced, cfg.t_bins), jnp.int32)

    def render_pass(self, key, cnt):
        color, bins, cnts = render_pass_bdpt(self.scene, self.cfg, key,
                                             jnp.asarray(cnt, jnp.int32))
        if self.is_transient:
            self.time_bins = self.time_bins + bins
            self.time_cnts = self.time_cnts + cnts
        return color

    def render_batch(self, spp: int):
        if self.is_transient:
            return super().render_batch(spp)
        self.key, sub = jax.random.split(self.key)
        acc = render_batch_bdpt(self.scene, self.cfg, sub,
                                jnp.int32(self.cnt + 1), spp)
        self.cnt += spp
        self.color = self.color + acc.reshape(self.cfg.w, self.cfg.h, 3)
        return self.color

    # transient runs checkpoint their histograms too — resuming with only
    # color/cnt would export transient frames built from post-resume
    # samples while the steady image includes all of them
    def get_check_point(self) -> dict:
        chk = super().get_check_point()
        if self.is_transient:
            chk.update(transient_check_point(self.cfg, self.time_bins,
                                             self.time_cnts))
        return chk

    def load_check_point(self, chk: dict):
        # validate BEFORE any state mutates (base does the same for its
        # keys) so a rejected checkpoint leaves the renderer untouched
        bins, cnts = validate_transient_check_point(
            self.cfg, chk,
            self.time_bins.shape if self.is_transient else None,
            self.time_cnts.shape if self.is_transient else None,
            self.is_transient)
        super().load_check_point(chk)
        if self.is_transient:
            self.time_bins = bins
            self.time_cnts = cnts

    def copy_average(self, time_idx: int):
        return transient_copy_average(self.cfg, self.time_bins,
                                      self.time_cnts, self._pix_ids,
                                      time_idx)

    def transient_frames(self):
        return transient_frames_np(self.cfg, self.time_bins,
                                   self.time_cnts, self._pix_ids)
