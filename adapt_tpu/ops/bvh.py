"""Wavefront BVH traversal over the skip-offset flat layout (device side).

The native binned-SAH builder (native/bvh_builder.cpp) emits nodes in DFS
order where each node stores the index of the next node to visit when its
AABB test fails (`skip`); descending on a hit is just `cursor + 1`. That
makes traversal a single per-lane integer cursor — no stack — which maps
cleanly onto a batched lax.while_loop.

This replaces the reference's per-ray DFS walk (tracer/path_tracer.py:
338-422, tracer/ti_bvh.py) with a lane-synchronous wavefront loop.

Layout note: all node data rides ONE packed (M,9) row-gather per step and
all leaf-prim data ONE packed (P,14) row-gather per leaf slot, the prim
rows pre-reordered leaf-contiguous at scene compile (a field-per-field
form issues ~45 separate per-lane gathers per step).

The loop is lockstep: every step runs the full-width masked body until
the slowest lane finishes. This is the intersector for scenes above
scene/compile.SMALL_SCENE_PRIMS prims on the GPU, and from
scene/compile.BVH_THRESHOLD prims on the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .intersect import RAY_EPS, FAR

LEAF_MAX = 4          # must match native kLeafMax


def _slab_test(ray_o, inv_d, lo, hi, t_max):
    """Vectorized ray/AABB slab test; True when the box is hit before
    t_max (reference ti_bvh.py:30-53 semantics)."""
    t1 = (lo - ray_o) * inv_d
    t2 = (hi - ray_o) * inv_d
    t_near = jnp.minimum(t1, t2).max(-1)
    t_far = jnp.maximum(t1, t2).min(-1)
    return (t_far >= jnp.maximum(t_near, 0.0)) & (t_near < t_max)


def _leaf_prim_test(row, valid, ray_o, ray_d):
    """Single-prim intersection from a packed (N,14) prim row.

    Row layout: n|center(0:3) d|radius(3) U(4:7) cu(7) V(8:11) cv(11)
    is_sphere(12) gid(13). Returns (t, gid, u, v); t = FAR when
    invalid/miss."""
    a = row[:, 0:3]
    b = row[:, 3]
    is_sph = row[:, 12] > 0.5
    gid = row[:, 13].astype(jnp.int32)
    # triangle: precomputed plane + dual basis
    o_n = jnp.sum(ray_o * a, -1)
    d_n = jnp.sum(ray_d * a, -1)
    safe_dn = jnp.where(jnp.abs(d_n) < 1e-12, 1e-12, d_n)
    t_tri = (b - o_n) / safe_dn
    hitp = ray_o + t_tri[..., None] * ray_d
    u = jnp.sum(hitp * row[:, 4:7], -1) - row[:, 7]
    v = jnp.sum(hitp * row[:, 8:11], -1) - row[:, 11]
    tri_ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t_tri > RAY_EPS) \
        & (jnp.abs(d_n) >= 1e-12)
    # sphere: quadratic (center in a, radius in b)
    s2c = a - ray_o
    cn2 = jnp.sum(s2c * s2c, -1)
    proj = jnp.sum(ray_d * s2c, -1)
    c2r = cn2 - proj * proj
    r2 = b * b
    cut = jnp.sqrt(jnp.maximum(r2 - c2r, 0.0))
    outside = cn2 > r2 + 1e-4
    t_sph = proj + jnp.where(outside, -cut, cut)
    sph_ok = (c2r < r2) & (t_sph > RAY_EPS)

    t = jnp.where(is_sph, jnp.where(sph_ok, t_sph, FAR),
                  jnp.where(tri_ok, t_tri, FAR))
    t = jnp.where(valid, t, FAR)
    return t, gid, u, v


def traverse(scene, ray_o, ray_d, max_t=None, any_hit=False, alive=None):
    """Closest-hit (or any-hit) BVH traversal for a ray wavefront.

    Returns (best_t, best_prim, best_u, best_v) — best_t clipped at max_t
    and best_prim = -1 on miss. With any_hit=True, lanes stop at the first
    accepted hit (shadow rays). alive: optional (N,) bool — dead lanes are
    forced to miss (best_t=-3e38, prim=-1) and never walk the tree, so all
    dispatch tiers honor the same forced-miss contract."""
    N = ray_o.shape[0]
    M = scene.bvh_node_pack.shape[0]
    P = scene.bvh_prim_pack.shape[0]
    far0 = jnp.full((N,), FAR, jnp.float32) if max_t is None \
        else jnp.where(max_t > 0.0, max_t - RAY_EPS, FAR)
    inv_d = 1.0 / jnp.where(jnp.abs(ray_d) < 1e-9, 1e-9, ray_d)

    cursor0 = jnp.zeros((N,), jnp.int32)
    if alive is not None:
        far0 = jnp.where(alive, far0, -3e38)
        cursor0 = jnp.where(alive, cursor0, M)

    st = dict(cursor=cursor0,
              best_t=far0,
              best_prim=jnp.full((N,), -1, jnp.int32),
              best_u=jnp.zeros((N,), jnp.float32),
              best_v=jnp.zeros((N,), jnp.float32))

    def cond(st):
        return jnp.any(st["cursor"] < M)

    def body(st):
        c = jnp.minimum(st["cursor"], M - 1)
        active = st["cursor"] < M
        if any_hit:
            active &= st["best_prim"] < 0
        node = scene.bvh_node_pack[c]                # ONE gather: (N, 9)
        lo, hi = node[:, 0:3], node[:, 3:6]
        base = node[:, 6].astype(jnp.int32)
        cnt = node[:, 7].astype(jnp.int32)
        skip = node[:, 8].astype(jnp.int32)
        hit_box = _slab_test(ray_o, inv_d, lo, hi, st["best_t"]) & active
        is_leaf = cnt > 0

        best_t, best_prim = st["best_t"], st["best_prim"]
        best_u, best_v = st["best_u"], st["best_v"]
        for k in range(LEAF_MAX):
            valid = hit_box & is_leaf & (k < cnt)
            row = scene.bvh_prim_pack[jnp.minimum(base + k, P - 1)]
            t, gid, u, v = _leaf_prim_test(row, valid, ray_o, ray_d)
            better = t < best_t
            best_prim = jnp.where(better, gid, best_prim)
            best_u = jnp.where(better, u, best_u)
            best_v = jnp.where(better, v, best_v)
            best_t = jnp.where(better, t, best_t)

        cursor = jnp.where(active, jnp.where(hit_box, c + 1, skip), M)
        if any_hit:
            cursor = jnp.where(best_prim >= 0, M, cursor)
        return dict(cursor=cursor, best_t=best_t, best_prim=best_prim,
                    best_u=best_u, best_v=best_v)

    st = jax.lax.while_loop(cond, body, st)
    return st["best_t"], st["best_prim"], st["best_u"], st["best_v"]
