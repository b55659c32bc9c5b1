"""Wavefront ray-scene intersection (device side).

Instead of the reference's per-ray divergent loop with a 3x3 matrix
inverse per triangle (tracer_base.py:199-214), the triangle test is
algebraically rewritten into a *plane + dual-basis barycentric* form whose
batched evaluation is all-pairs dot products plus elementwise ops:

    t = (d_p - o.n) / (dir.n)
    u = (o + t dir).U - cu,   v = (o + t dir).V - cv

with n, U, V, d_p, cu, cv precomputed per triangle at scene-compile time
(scene/compile.py). Which intersector a scene uses is fixed at compile
time (scene/compile.py `choose_intersector`): the jnp chunk scan below
(triangles in fixed-size chunks through a lax.scan running min), the
Pallas kernels of ops/intersect_pallas.py, or the BVH walk of ops/bvh.py.

Sphere primitives use the reference's quadratic form (tracer_base.py:183-198)
vectorized over the (N, S) grid.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..constants import INV_PI, INV_2PI
from .math3d import dot, normalize

RAY_EPS = 1e-4
FAR = 1e7
# Max elements per (N, C) intermediate; keeps peak memory bounded.
MAX_LANES = 1 << 24


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@dataclasses.dataclass
class Interaction:
    """SoA interaction record for a ray batch (reference tracer/interaction.py)."""
    obj_id: jnp.ndarray    # (N,) i32, -1 = miss
    prim_id: jnp.ndarray   # (N,) i32 global prim index
    t: jnp.ndarray         # (N,) hit distance (FAR on miss)
    n_g: jnp.ndarray       # (N,3) geometric normal
    n_s: jnp.ndarray       # (N,3) shading normal
    uv: jnp.ndarray        # (N,2) local barycentric uv (or sphere angles)
    tex: jnp.ndarray       # (N,3) albedo texture color, -1 = invalid

    @property
    def is_hit(self):
        return self.obj_id >= 0


def _chunk_size(n_rays: int, n_items: int) -> int:
    c = max(1, MAX_LANES // max(n_rays, 1))
    return min(n_items, c)


def _pad_to(x, size, fill):
    pad = size - x.shape[0]
    if pad == 0:
        return x
    pad_width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad_width, constant_values=fill)


def _tri_chunks(scene, chunk: int):
    """Reshape triangle SoA into (n_chunks, chunk, ...) scan operands."""
    T = scene.tri_n.shape[0]
    n_chunks = -(-T // chunk)
    size = n_chunks * chunk

    def prep(x, fill=0.0):
        return _pad_to(x, size, fill).reshape((n_chunks, chunk) + x.shape[1:])

    return (prep(scene.tri_n), prep(scene.tri_d, FAR), prep(scene.tri_U),
            prep(scene.tri_V), prep(scene.tri_cu), prep(scene.tri_cv),
            prep(scene.tri_gid, -1))


def _pair_dots(a, b):
    """Exact all-pairs f32 dot products: (N,3)x(C,3) -> (N,C).

    Deliberately NOT a matmul: with K=3 a matrix unit does no useful work,
    and GEMMs may run at reduced precision (TF32 on the GPU, unless the
    package-wide 'highest' pin holds), which breaks geometric predicates
    (false self-intersections at RAY_EPS scale). The expanded mul+sum is
    exact f32 and XLA fuses the broadcast into the reduction, so nothing
    (N,C,3) is materialized."""
    return (a[:, None, :] * b[None, :, :]).sum(-1)


def _tri_hit_chunk(ray_o, ray_d, tn, td, tU, tV, tcu, tcv):
    """All-pairs triangle test for one chunk; returns (t, u, v, valid)."""
    o_n = _pair_dots(ray_o, tn)
    o_u = _pair_dots(ray_o, tU)
    o_v = _pair_dots(ray_o, tV)
    d_n = _pair_dots(ray_d, tn)
    d_u = _pair_dots(ray_d, tU)
    d_v = _pair_dots(ray_d, tV)
    denom = jnp.where(jnp.abs(d_n) < 1e-12, 1e-12, d_n)
    t = (td[None, :] - o_n) / denom
    u = o_u + t * d_u - tcu[None, :]
    v = o_v + t * d_v - tcv[None, :]
    valid = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > RAY_EPS) \
        & (jnp.abs(d_n) >= 1e-12)
    return t, u, v, valid


def _sphere_hit(ray_o, ray_d, center, radius):
    """Vectorized reference sphere test (tracer_base.py:183-198).

    ray_o (N,3), center (S,3) -> (N,S) hit distance (or -1)."""
    s2c = center[None, :, :] - ray_o[:, None, :]        # (N,S,3)
    cn2 = jnp.sum(s2c * s2c, axis=-1)                   # (N,S)
    proj = jnp.einsum("nd,nsd->ns", ray_d, s2c)
    r2 = (radius * radius)[None, :]
    c2r = cn2 - proj * proj
    inside_disc = c2r < r2
    cut = jnp.sqrt(jnp.maximum(r2 - c2r, 0.0))
    outside = cn2 > r2 + 1e-4
    ray_t = proj + jnp.where(outside, -cut, cut)
    return jnp.where(inside_disc, ray_t, -1.0)


def ray_intersect(scene, cfg, ray_o, ray_d, max_t=None, alive=None):
    """Closest-hit intersection for a ray batch; returns Interaction.

    max_t: optional (N,) clip distance (reference min_depth semantics:
    hits are only accepted strictly before max_t - eps). alive: optional
    (N,) bool — dead lanes are forced to miss (far0 = -big), so renderers
    pass their terminated-ray mask and late bounces only pay for
    surviving rays. Dispatch (cfg, see scene/compile.choose_intersector):
    BVH walk, Pallas triangle kernel, or the jnp chunk scan."""
    if cfg.use_bvh and not cfg.use_pallas:
        from .bvh import traverse
        best_t, best_prim, best_u, best_v = traverse(scene, ray_o, ray_d,
                                                     max_t, alive=alive)
        is_sphere_hit = scene.prim_is_sphere[jnp.maximum(best_prim, 0)] \
            & (best_prim >= 0)
        return _assemble_interaction(scene, cfg, ray_o, ray_d, best_t,
                                     best_prim, best_u, best_v,
                                     is_sphere_hit)
    N = ray_o.shape[0]
    far0 = jnp.full((N,), FAR, jnp.float32) if max_t is None \
        else jnp.where(max_t > 0.0, max_t - RAY_EPS, FAR)

    best_t = far0
    best_prim = jnp.full((N,), -1, jnp.int32)
    best_u = jnp.zeros((N,), jnp.float32)
    best_v = jnp.zeros((N,), jnp.float32)

    if alive is not None:
        far0 = jnp.where(alive, far0, -3e38)
        best_t = far0

    T = scene.tri_n.shape[0]
    pre_ng = pre_obj = None
    if T > 0 and cfg.use_pallas:
        from .intersect_pallas import tri_closest_hit
        best_t, best_prim, best_u, best_v, pre_ng, pre_obj = \
            tri_closest_hit(scene, ray_o, ray_d, far0)
    elif T > 0:
        chunk = _chunk_size(N, T)
        ops = _tri_chunks(scene, chunk)

        def body(carry, op):
            from .gather import select_along
            bt, bp, bu, bv = carry
            tn, td, tU, tV, tcu, tcv, gid = op
            t, u, v, valid = _tri_hit_chunk(ray_o, ray_d, tn, td, tU, tV,
                                            tcu, tcv)
            valid &= (gid >= 0)[None, :]
            t = jnp.where(valid, t, FAR)
            # argmin + one-hot selection of the winner's fields
            idx = jnp.argmin(jnp.where(t < bt[:, None], t, FAR), axis=1)
            cand_t = select_along(t, idx)
            better = cand_t < bt
            sel = lambda new, old: jnp.where(better, new, old)
            bt = sel(cand_t, bt)
            bp = sel(select_along(jnp.broadcast_to(gid[None, :], t.shape),
                                  idx), bp)
            bu = sel(select_along(u, idx), bu)
            bv = sel(select_along(v, idx), bv)
            return (bt, bp, bu, bv), None

        (best_t, best_prim, best_u, best_v), _ = jax.lax.scan(
            body, (best_t, best_prim, best_u, best_v), ops)

    S = scene.sph_center.shape[0]
    is_sphere_hit = jnp.zeros((N,), bool)
    if S > 0:
        from .gather import select_along
        ts = _sphere_hit(ray_o, ray_d, scene.sph_center, scene.sph_radius)
        ts = jnp.where(ts > RAY_EPS, ts, FAR)
        si = jnp.argmin(ts, axis=1)
        st = select_along(ts, si)
        better = st < best_t
        gids = jnp.broadcast_to(scene.sph_gid[None, :], ts.shape)
        best_prim = jnp.where(better, select_along(gids, si), best_prim)
        best_t = jnp.where(better, st, best_t)
        is_sphere_hit = better

    return _assemble_interaction(scene, cfg, ray_o, ray_d, best_t,
                                 best_prim, best_u, best_v, is_sphere_hit,
                                 pre_ng, pre_obj)


def _assemble_interaction(scene, cfg, ray_o, ray_d, best_t, best_prim,
                          best_u, best_v, is_sphere_hit, pre_ng=None,
                          pre_obj=None):
    """Build the Interaction record from raw hit data
    (reference tracer_base.py:215-237).

    pre_ng/pre_obj: per-lane normal / object id already resolved by the
    Pallas kernel (it carries them with the running hit, saving two
    table lookups here)."""
    from .gather import tgather
    N = ray_o.shape[0]
    hit = best_prim >= 0
    prim = jnp.maximum(best_prim, 0)
    S = scene.sph_center.shape[0]
    if pre_obj is not None:
        obj_id = pre_obj
        if S > 0:
            obj_id = jnp.where(is_sphere_hit,
                               _prim_to_obj(scene, prim, is_sphere_hit),
                               pre_obj)
        obj_id = jnp.where(hit, obj_id, -1)
    else:
        obj_id = jnp.where(hit, _prim_to_obj(scene, prim, is_sphere_hit), -1)

    # --- normals / uv assembly (reference tracer_base.py:215-237) ---
    n_g_tri = pre_ng if pre_ng is not None else tgather(scene.prim_ng, prim)
    hit_p = ray_o + best_t[:, None] * ray_d
    if S > 0:
        center = tgather(scene.pre0, prim)  # sphere center lives in pre0
        n_sphere = normalize(hit_p - center)
        sph_u = (jnp.arctan2(n_sphere[..., 1], n_sphere[..., 0]) + jnp.pi) \
            * INV_2PI
        sph_v = jnp.arccos(jnp.clip(n_sphere[..., 2], -1.0, 1.0)) * INV_PI
        n_g = jnp.where(is_sphere_hit[:, None], n_sphere, n_g_tri)
        best_u = jnp.where(is_sphere_hit, sph_u, best_u)
        best_v = jnp.where(is_sphere_hit, sph_v, best_v)
    else:
        n_g = n_g_tri

    if cfg.has_v_normal:
        vn = tgather(scene.prim_vn, prim)                 # (N,3,3)
        w0 = (1.0 - best_u - best_v)[:, None]
        n_s_tri = vn[:, 0] * w0 + vn[:, 1] * best_u[:, None] \
            + vn[:, 2] * best_v[:, None]
        # spheres / missing vertex normals fall back to n_g
        vn_ok = jnp.sum(jnp.abs(vn), axis=(1, 2)) > 1e-6
        n_s = jnp.where((vn_ok & ~is_sphere_hit)[:, None], n_s_tri, n_g)
        n_s = normalize(n_s)
    else:
        n_s = n_g

    default_n = jnp.array([1.0, 0.0, 0.0], jnp.float32)
    n_g = jnp.where(hit[:, None], n_g, default_n)
    n_s = jnp.where(hit[:, None], n_s, default_n)

    return Interaction(
        obj_id=obj_id.astype(jnp.int32),
        prim_id=prim.astype(jnp.int32),
        t=best_t,
        n_g=n_g, n_s=n_s,
        uv=jnp.stack([best_u, best_v], axis=-1),
        # STATICALLY None when the scene has no albedo textures: keeps
        # the (dead) tex plane out of integrator loop carries, where a
        # constant plane measurably broke bounce-loop fusion (r2 -31%)
        tex=(jnp.full((N, 3), -1.0, jnp.float32)
             if scene.tex["albedo"].present else None),
    )


def _sort_by(key, arrays):
    """Reorder arrays by ascending key via ONE multi-operand lax.sort
    (the wavefront compaction sorts of renderer/compact.py and
    ops/volume_ops.py). (N,k) arrays ride as k scalar operands."""
    ops = [key]
    widths = []
    for a in arrays:
        if a.ndim == 1:
            ops.append(a)
            widths.append(0)
        else:
            ops.extend(a[:, i] for i in range(a.shape[1]))
            widths.append(a.shape[1])
    out = jax.lax.sort(tuple(ops), num_keys=1)[1:]
    res = []
    i = 0
    for w in widths:
        if w == 0:
            res.append(out[i])
            i += 1
        else:
            res.append(jnp.stack(out[i:i + w], axis=1))
            i += w
    return res


def _unsort(perm, arrays):
    """Inverse of a _sort_by permutation: row i of each array goes back to
    row perm[i] (perm: the lane ids that rode the forward sort). A
    scatter, not a second sort by perm: XLA's GPU compiler rewrites a
    sort keyed on a permutation into a scatter itself, and for mixed
    s32/f32 operands that rewrite (permutation_sort_simplifier) emits
    HLO its own verifier rejects."""
    return [jnp.zeros_like(a).at[perm].set(a, unique_indices=True)
            for a in arrays]


def _prim_to_obj(scene, prim, is_sphere_hit):
    """Global prim id -> object id.

    A precomputed (P,) table lookup, not jnp.searchsorted: the binary
    search lowers to a serialized while_loop over the wavefront."""
    from .gather import tgather
    return tgather(scene.prim_obj, prim)


def does_intersect(scene, cfg, ray_o, ray_d, max_t=None, alive=None):
    """Boolean occlusion test (shadow rays); any hit strictly before max_t.

    alive: see ray_intersect — dead lanes return un-occluded."""
    if cfg.use_bvh and not cfg.use_pallas:
        from .bvh import traverse
        _t, prim, _u, _v = traverse(scene, ray_o, ray_d, max_t,
                                    any_hit=True, alive=alive)
        return prim >= 0
    N = ray_o.shape[0]
    far = jnp.full((N,), FAR, jnp.float32) if max_t is None \
        else jnp.where(max_t > 0.0, max_t - RAY_EPS, FAR)
    if alive is not None:
        far = jnp.where(alive, far, -3e38)
    occluded = jnp.zeros((N,), bool)

    T = scene.tri_n.shape[0]
    if T > 0 and cfg.use_pallas:
        from .intersect_pallas import tri_any_hit
        occluded |= tri_any_hit(scene, ray_o, ray_d, far)
    elif T > 0:
        chunk = _chunk_size(N, T)
        ops = _tri_chunks(scene, chunk)

        def body(occ, op):
            tn, td, tU, tV, tcu, tcv, gid = op
            t, _u, _v, valid = _tri_hit_chunk(ray_o, ray_d, tn, td, tU, tV,
                                              tcu, tcv)
            valid &= (gid >= 0)[None, :] & (t < far[:, None])
            return occ | jnp.any(valid, axis=1), None

        occluded, _ = jax.lax.scan(body, occluded, ops)

    if scene.sph_center.shape[0] > 0:
        ts = _sphere_hit(ray_o, ray_d, scene.sph_center, scene.sph_radius)
        occluded |= jnp.any((ts > RAY_EPS) & (ts < far[:, None]), axis=1)
    return occluded
