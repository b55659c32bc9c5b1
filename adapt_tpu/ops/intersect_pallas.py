"""Pallas (Triton route) kernels for small-scene ray-triangle intersection.

Why this exists: the jnp chunk scan (ops/intersect.py) evaluates every
(ray, triangle) pair as an (N, C) table per scan step — six pair-dot
tables, then t/u/v/valid, an argmin and one-hot selects — and XLA moves
those tables through device memory between fusions. Here one program
takes a tile of BLOCK rays, keeps them in registers, and loops over the
triangle table one row at a time: the running closest hit (t, u, v,
normal, object, prim id) stays in registers and nothing (N, C)-shaped is
ever written. The table (<= 256 rows x 17 floats) is read as scalars that
every thread of the block shares, so it lives in L1.

The math is ops/intersect.py `_tri_hit_chunk` (plane + dual-basis
barycentric form, same op order); hit decisions agree with the jnp path
except where FMA contraction or the division's rounding moves a grazing
hit across an edge (chip_smoke.py states the bounds and checks them on
the card).

Reference behavior: tracer_base.py:199-214 (triangle test contract),
ray_intersect/does_intersect dispatch (tracer_base.py:159-278).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

RAY_EPS = 1e-4
FAR = 1e7
BLOCK = 128            # rays per program (one per thread at 4 warps)
NUM_WARPS = 4

# table columns: n(0:3) d(3) U(4:7) cu(7) V(8:11) cv(11) n_g(12:15)
# obj(15) gid(16); ints ride f32 (exact below 2^24)
_N_COLS = 17

_INTERPRET = False     # tests flip this to run the kernels on the CPU


def _table(scene):
    """(T, 17) f32 triangle rows for the kernels."""
    f = jnp.float32
    return jnp.concatenate([
        scene.tri_n, scene.tri_d[:, None], scene.tri_U,
        scene.tri_cu[:, None], scene.tri_V, scene.tri_cv[:, None],
        scene.prim_ng[scene.tri_gid],
        scene.tri_obj[:, None].astype(f), scene.tri_gid[:, None].astype(f),
    ], axis=1).astype(f)


def _ray_columns(ray_o, ray_d, far0):
    """Seven (Np,) ray columns padded to a BLOCK multiple; pad lanes get a
    unit direction and a dead far clip so they never hit."""
    N = ray_o.shape[0]
    Np = -(-N // BLOCK) * BLOCK

    def pad(x, fill):
        return jnp.pad(x, (0, Np - N), constant_values=fill)

    cols = [pad(ray_o[:, k], 0.0) for k in range(3)] \
        + [pad(ray_d[:, k], 1.0) for k in range(3)] + [pad(far0, -3e38)]
    return cols, Np


def _tri_test(tab, i, o, d):
    """Row i of the table against the block's rays -> (t, u, v, valid)."""
    def dot(v, c):
        return (v[0] * tab[i, c] + v[1] * tab[i, c + 1]) \
            + v[2] * tab[i, c + 2]

    o_n, d_n = dot(o, 0), dot(d, 0)
    o_u, d_u = dot(o, 4), dot(d, 4)
    o_v, d_v = dot(o, 8), dot(d, 8)
    small = jnp.abs(d_n) < 1e-12
    t = (tab[i, 3] - o_n) / jnp.where(small, 1e-12, d_n)
    u = o_u + t * d_u - tab[i, 7]
    v = o_v + t * d_v - tab[i, 11]
    valid = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > RAY_EPS) \
        & ~small
    return t, u, v, valid


def _load_rays(refs):
    ox, oy, oz, dx, dy, dz, far = (r[...] for r in refs)
    return (ox, oy, oz), (dx, dy, dz), far


def _closest_kernel(*refs, n_tris):
    o, d, far = _load_rays(refs[:7])
    tab = refs[7]
    t_out, gid_out, u_out, v_out, ng0_out, ng1_out, ng2_out, obj_out = \
        refs[8:]
    zero = jnp.zeros_like(far)
    neg = jnp.full(far.shape, -1.0, jnp.float32)

    def body(i, c):
        bt, bu, bv, n0, n1, n2, bo, bg = c
        t, u, v, valid = _tri_test(tab, i, o, d)
        # strict < keeps the first row on ties (jnp.argmin semantics)
        better = valid & (t < bt)

        def sel(new, old):
            return jnp.where(better, new, old)

        return (sel(t, bt), sel(u, bu), sel(v, bv), sel(tab[i, 12], n0),
                sel(tab[i, 13], n1), sel(tab[i, 14], n2), sel(tab[i, 15], bo),
                sel(tab[i, 16], bg))

    # miss defaults: t = far, n_g = (1, 0, 0) (_assemble_interaction's
    # default_n), obj = gid = -1
    init = (far, zero, zero, zero + 1.0, zero, zero, neg, neg)
    bt, bu, bv, n0, n1, n2, bo, bg = jax.lax.fori_loop(0, n_tris, body,
                                                       init)
    t_out[...] = bt
    u_out[...] = bu
    v_out[...] = bv
    ng0_out[...] = n0
    ng1_out[...] = n1
    ng2_out[...] = n2
    obj_out[...] = bo.astype(jnp.int32)
    gid_out[...] = bg.astype(jnp.int32)


def _any_kernel(*refs, n_tris):
    o, d, far = _load_rays(refs[:7])
    tab, occ_out = refs[7], refs[8]

    def body(i, occ):
        t, _u, _v, valid = _tri_test(tab, i, o, d)
        return jnp.where(valid & (t < far), 1, occ)

    occ_out[...] = jax.lax.fori_loop(0, n_tris, body,
                                     jnp.zeros(far.shape, jnp.int32))


def _call(kernel, scene, ray_o, ray_d, far0, out_dtypes, name):
    T = scene.tri_n.shape[0]
    cols, Np = _ray_columns(ray_o, ray_d, far0)
    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    tab_spec = pl.BlockSpec((T, _N_COLS), lambda i: (0, 0))
    outs = pl.pallas_call(
        functools.partial(kernel, n_tris=T),
        grid=(Np // BLOCK,),
        in_specs=[ray_spec] * 7 + [tab_spec],
        out_specs=[ray_spec] * len(out_dtypes),
        out_shape=[jax.ShapeDtypeStruct((Np,), dt) for dt in out_dtypes],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=_INTERPRET,
        name=name,
    )(*cols, _table(scene))
    return [x[:ray_o.shape[0]] for x in outs]


def tri_closest_hit(scene, ray_o, ray_d, far0):
    """Closest triangle hit for a ray batch.

    Returns (t, gid, u, v, n_g, obj): t = far0, gid/obj = -1, u = v = 0
    and n_g = (1, 0, 0) on a miss; gid is the global prim id. Hits count
    only strictly before far0."""
    f, i = jnp.float32, jnp.int32
    t, gid, u, v, n0, n1, n2, obj = _call(
        _closest_kernel, scene, ray_o, ray_d, far0,
        (f, i, f, f, f, f, f, i), "tri_closest_hit")
    return t, gid, u, v, jnp.stack([n0, n1, n2], axis=-1), obj


def tri_any_hit(scene, ray_o, ray_d, far0):
    """True where any triangle lies strictly before far0."""
    (occ,) = _call(_any_kernel, scene, ray_o, ray_d, far0, (jnp.int32,),
                   "tri_any_hit")
    return occ > 0
