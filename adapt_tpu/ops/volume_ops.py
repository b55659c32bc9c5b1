"""Heterogeneous grid-volume transport: delta/ratio tracking (device side).

Wavefront equivalents of the reference's per-ray stochastic loops
(bxdf/volume.py:263-463): spectral single-channel selection by
throughput-weighted majorant pdf, majorant-exponential free-flight stepping,
stochastic nearest-neighbor density lookups, and ratio-tracking
transmittance with Russian-roulette termination.

The unbounded per-ray while-loops become one batched lax.while_loop that
runs until every lane is done (hard-capped at MAX_STEPS, generous enough
that the residual bias is below f32 noise for shipped majorants). Per-step
randomness comes from folding the step counter into a base key, so lanes
stay independent without carrying per-lane key state.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..constants import VolumeTag
from .gather import select_along, tgather

MAX_STEPS = 1024
# HISTORY — J-batch (r4, knob removed; superseded by the hop-chain
# below): J candidate steps per while-iteration through one J-major
# gather was distribution-exact but a MEASURED DEAD END (rgbvol 0.838
# J=1 -> 0.873 J=4, chain13 ablations 2026-08-20): it amortized loop
# overhead without cutting the per-ray GATHER count, and the J-unrolled
# _sv_step chains grew the body faster than the saved iteration
# overhead. The hop-chain differs in exactly that dimension — it
# removes gather PASSES — which is why it won where J-batch lost.
import os as _os
# HOP-CHAIN depth (r5, supersedes the J-batch in the march bodies): each
# while-iteration advances up to VOL_HOPS supervoxel DDA steps in
# registers, FREEZING at the lane's next collision candidate, then does
# ONE shared density gather for the frozen candidates. Distinct from
# VOL_J in exactly the dimension that made J-batching lose: the gather
# count per ray drops from (hops + candidates) to ~(candidates +
# hops/VOL_HOPS) — it removes gather PASSES, not just loop iterations.
# Hop sub-steps cost only the one-hot sv-majorant lookup (no random
# device-memory access). VOL_HOPS=1 reproduces the old per-step-gather
# cost shape.
VOL_HOPS = int(_os.environ.get("ADAPT_VOL_HOPS", "4"))
# Reverse-mode differentiable tracking (r5, VERDICT r4 #7): lax.while_loop
# has no reverse-mode AD rule, so when DIFF_STEPS > 0 the ratio-tracking
# march runs a FIXED DIFF_STEPS-iteration fori_loop instead (the body is
# already done-masked, so extra iterations are no-ops). With the majorant
# field held constant (lax.stop_gradient at the call site), the candidate
# point process is independent of the density parameters and
# d/d(grid) E[tr] = E[d/d(grid) tr] — the pathwise gradient of the ratio
# factors (1 - d/maj) is unbiased. Used by density-grid recovery
# (tests/test_grad_volume.py, scripts/recover_volume.py).
DIFF_STEPS = 0
# march-while body repetition (distinct from VOL_J: keeps one gather per
# sub-step, halving iteration count without growing any single op — the
# VPT bounce loop's 2x unroll bought 0.4 ms per removed iteration where
# the gather-merging J-batch lost; this isolates which property matters)
VOL_UNROLL = int(_os.environ.get("ADAPT_VOL_UNROLL", "1"))


def _unrolled(body):
    if VOL_UNROLL <= 1:
        return body

    def rep(st):
        for _ in range(VOL_UNROLL):
            st = body(st)
        return st
    return rep


_ABLATE = None      # timing experiments only (scripts/bench_volume.py)


def _register(cls, meta=()):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(
        cls, data_fields=[f for f in fields if f not in meta],
        meta_fields=list(meta))
    return cls


@dataclasses.dataclass
class GridVolumeData:
    """Device-side grid volume (reference volume.py:239-261).

    The kind tag lives in RenderConfig (static) so absent volumes compile
    to nothing."""
    grid: jnp.ndarray       # (3, Z, Y, X) channel-major density
    albedo: jnp.ndarray     # (3,)
    inv_T: jnp.ndarray      # (3,3) world -> index space
    trans: jnp.ndarray      # (3,) translation
    mini: jnp.ndarray       # (3,) world AABB
    maxi: jnp.ndarray
    majorant: jnp.ndarray   # (3,) global majorants (spectral pick pdf)
    pdf: jnp.ndarray        # (3,) majorant / sum
    ph_par: jnp.ndarray     # (3,) phase params
    ph_pdf: jnp.ndarray     # (3,) multi-HG lobe weights
    # (3, SZ, SY, SX) per-supervoxel LOCAL majorants (dilated blockwise
    # maxima): the tracking marches at the local rate and DDA-skips
    # supervoxel boundaries, cutting collision candidates ~mean(local)/
    # global (0.055 on the cbox-volgrid tornado at sv_size=16)
    sv_maj: jnp.ndarray
    sv_size: int = 1        # STATIC supervoxel edge in voxels


_register(GridVolumeData, meta=("sv_size",))


def dummy_volume() -> GridVolumeData:
    z3 = jnp.zeros(3, jnp.float32)
    return GridVolumeData(
        grid=jnp.zeros((3, 1, 1, 1), jnp.float32), albedo=jnp.ones(3),
        inv_T=jnp.eye(3), trans=z3, mini=z3, maxi=z3,
        majorant=jnp.ones(3), pdf=jnp.full(3, 1 / 3), ph_par=z3,
        ph_pdf=jnp.array([1.0, 0.0, 0.0]),
        sv_maj=jnp.zeros((3, 1, 1, 1), jnp.float32), sv_size=1)


# Supervoxel grid axis cap: higher = finer supervoxels = tighter local
# majorants = fewer collision candidates (fewer density gathers), at the
# cost of a bigger factorized one-hot lookup (row dim 3*SZ*SY: 192 at
# cap 8, 768 at cap 16) and more DDA hops. Chosen by a sweep on another
# accelerator (scripts/sweep_sv.py); not re-swept on the GPU yet.
SV_AXIS_CAP = int(_os.environ.get("ADAPT_SV_CAP", "16"))


def _supervoxel_majorants(dens):
    """(3, Z, Y, X) density -> (sv_size, (3, SZ, SY, SX) local majorants).

    Each supervoxel's value is the max density over its block DILATED by
    one voxel on every side: _density_lookup's stochastic NN jitter
    (pos + u - 0.5) can read a neighbor voxel of the sample position, so
    the local majorant must cover it. Outside-grid padding is density 0."""
    import numpy as np
    _, Z, Y, X = dens.shape
    S = 8
    while max(Z, Y, X) > S * SV_AXIS_CAP:
        S *= 2

    d = np.asarray(dens)
    for ax in (1, 2, 3):            # separable radius-1 max filter
        p = np.concatenate([d.take([0], ax), d, d.take([-1], ax)], axis=ax)
        n = d.shape[ax]
        d = np.maximum(np.maximum(p.take(range(0, n), ax),
                                  p.take(range(1, n + 1), ax)),
                       p.take(range(2, n + 2), ax))
    pz, py, px = [(-n) % S for n in (Z, Y, X)]
    d = np.pad(d, ((0, 0), (0, pz), (0, py), (0, px)))
    sv = d.reshape(3, (Z + pz) // S, S, (Y + py) // S, S,
                   (X + px) // S, S).max(axis=(2, 4, 6))
    return S, sv.astype(np.float32)


def compile_volume(rec) -> GridVolumeData:
    """Host GridVolumeRec -> device arrays."""
    import numpy as np
    mini, maxi = rec.world_aabb()
    maj = rec.majorant()
    grid_cm = np.moveaxis(rec.density_grid, -1, 0)
    sv_size, sv_maj = _supervoxel_majorants(grid_cm)
    return GridVolumeData(
        # channel-major (3, Z, Y, X): each channel is one contiguous
        # (Z, Y, X) volume, so a per-lane gather of the picked channel
        # never drags the other two channels' values along (a trailing
        # size-3 axis can also pad badly in tiled layouts).
        grid=jnp.asarray(grid_cm),
        albedo=jnp.asarray(rec.albedo),
        inv_T=jnp.asarray(rec.inv_T),
        trans=jnp.asarray(rec.offset),
        mini=jnp.asarray(mini.astype(np.float32)),
        maxi=jnp.asarray(maxi.astype(np.float32)),
        majorant=jnp.asarray(maj),
        pdf=jnp.asarray(maj / maj.sum()),
        ph_par=jnp.asarray(rec.par),
        ph_pdf=jnp.asarray(rec.phase_pdf),
        sv_maj=jnp.asarray(sv_maj),
        sv_size=int(sv_size))


def intersect_volume(vol, ray_o, ray_d, max_t):
    """Ray/AABB slab test -> (near, far) (reference volume.py:267-281)."""
    safe_d = jnp.where(jnp.abs(ray_d) < 1e-9, 1e-9, ray_d)
    t1 = (vol.mini[None, :] - ray_o) / safe_d
    t2 = (vol.maxi[None, :] - ray_o) / safe_d
    near = jnp.maximum(0.0, jnp.minimum(t1, t2).max(-1)) + 1e-5
    far = jnp.minimum(max_t, jnp.maximum(t1, t2).min(-1)) - 1e-5
    return near, far


def _to_local(vol, ray_o, ray_d):
    o = (ray_o - vol.trans[None, :]) @ vol.inv_T.T
    d = ray_d @ vol.inv_T.T
    return o, d


def _march_interval(vol, ray_o, ray_d, max_t):
    """March bounds in the shared ray parameter, from the LOCAL grid slab.

    The world-AABB test (intersect_volume) bounds the ROTATED grid's
    bounding box: under a rotation a ray can sit inside the world AABB
    but outside the local grid, where the supervoxel DDA's clipped cell
    has its boundary BEHIND the ray — the hop degenerates to its fp
    nudge and the march stalls until MAX_STEPS (86% of cbox-rgbvol
    camera lanes measured 2026-08-19, 24x cost). The local slab is both
    tighter and the correct domain: density is identically zero outside
    it. Extended 0.5 voxel per side because _density_lookup's stochastic
    NN jitter reads up to half a voxel past the boundary (the supervoxel
    majorants are dilated to cover exactly that band).

    Returns (lo, ld, near, far); empty intervals have near >= far."""
    lo, ld = _to_local(vol, ray_o, ray_d)
    Z, Y, X = vol.grid.shape[1], vol.grid.shape[2], vol.grid.shape[3]
    ext = jnp.array([X, Y, Z], jnp.float32) + 0.5
    par = jnp.abs(ld) < 1e-9
    safe_d = jnp.where(par, 1e-9, ld)
    t1 = (-0.5 - lo) / safe_d
    t2 = (ext[None, :] - lo) / safe_d
    lo_in = (lo > -0.5) & (lo < ext[None, :])
    tmin = jnp.where(par, jnp.where(lo_in, -jnp.inf, jnp.inf),
                     jnp.minimum(t1, t2))
    tmax = jnp.where(par, jnp.where(lo_in, jnp.inf, -jnp.inf),
                     jnp.maximum(t1, t2))
    near = jnp.maximum(0.0, tmin.max(-1)) + 1e-5
    far = jnp.minimum(max_t, tmax.min(-1)) - 1e-5
    return lo, ld, near, far


def _density_index(vol, pos, u3):
    """Stochastic-NN cell index for a density lookup
    (reference volume.py:307-314). Returns ((n,3) clipped index, (n,)
    in-bounds flag); the gather itself is batched across candidates
    (see _gather_candidates)."""
    idx = jnp.floor(pos + (u3 - 0.5)).astype(jnp.int32)
    Z, Y, X = vol.grid.shape[1], vol.grid.shape[2], vol.grid.shape[3]
    ok = ((idx >= 0).all(-1) & (idx[..., 0] <= X - 1)
          & (idx[..., 1] <= Y - 1) & (idx[..., 2] <= Z - 1))
    ci = jnp.clip(idx, 0, jnp.array([X - 1, Y - 1, Z - 1]))
    return ci, ok


def _gather_candidates(vol, ch, idx_list, ok_list):
    """ONE J-major flattened gather for a round's J candidate lookups.

    Batching J candidates per iteration pays the same gather elements in
    J x fewer loop iterations. J-major (concatenate, not (n, J) minor)
    so the small J axis is never the minor one."""
    n = ch.shape[0]
    J = len(idx_list)
    if _ABLATE == "const_density":   # timing-only: sizes the gather cost
        base = jnp.full((n,), 0.5, jnp.float32) * tgather(vol.majorant, ch)
        return [base * 1.0 for _ in range(J)]
    z = jnp.concatenate([i[:, 2] for i in idx_list])
    y = jnp.concatenate([i[:, 1] for i in idx_list])
    x = jnp.concatenate([i[:, 0] for i in idx_list])
    chf = jnp.concatenate([ch] * J)
    val = vol.grid[chf, z, y, x]                 # (J*n,) one gather
    return [jnp.where(ok_list[j], val[j * n:(j + 1) * n], 0.0)
            for j in range(J)]


def _pick_channel(vol, thp, u):
    """Throughput-weighted spectral channel pick
    (reference volume.py:352-375); returns (channel, pdf, majorant)."""
    pdfs = thp * vol.pdf[None, :]
    pdfs = pdfs / jnp.maximum(pdfs.sum(-1, keepdims=True), 1e-12)
    cdf0 = pdfs[:, 0]
    cdf1 = cdf0 + pdfs[:, 1]
    ch = (u > cdf0).astype(jnp.int32) + (u > cdf1).astype(jnp.int32)
    pdf = select_along(pdfs, ch)
    maj = tgather(vol.majorant, ch)
    return ch, pdf, maj


def _sv_lookup(vol, svi, ch):
    """Local majorant at integer supervoxel coords svi (n,3)=(x,y,z) for
    the picked channel.

    Factorized one-hot instead of a per-lane gather: one matmul over the
    (ch, z, y) rows (<= 3*16*16 = 768 by SV_AXIS_CAP) followed by an
    elementwise lane-select over x. The package pins matmul precision to
    highest (no TF32), so the lookup reproduces table values exactly — a
    rounded-down majorant would break the tracking's correctness."""
    M = vol.sv_maj
    _, SZ, SY, SX = M.shape
    rows = 3 * SZ * SY
    ridx = (ch * SZ + svi[:, 2]) * SY + svi[:, 1]
    oh = (ridx[:, None] == jnp.arange(rows, dtype=ridx.dtype)) \
        .astype(jnp.float32)
    T1 = oh @ M.reshape(rows, SX)
    return select_along(T1, svi[:, 0])


def _sv_step(vol, lo, ld, ch, t, u_flight, far):
    """One hierarchical-majorant step from parameter t.

    Returns (m_loc, t_cand, t_hop): the local majorant at t's
    supervoxel, the sampled collision-candidate parameter (inf where the
    local majorant is 0), and the parameter just past the supervoxel's
    exit. The caller takes the candidate when t_cand <= min(t_hop, far),
    else hops — exact null-collision tracking with a piecewise-constant
    majorant (the exponential's memorylessness makes restarting the
    flight at each boundary unbiased)."""
    S = float(vol.sv_size)
    _, SZ, SY, SX = vol.sv_maj.shape
    dims = jnp.array([SX, SY, SZ], jnp.int32)
    pos = lo + t[:, None] * ld
    # UNCLIPPED cell for the hop boundary: in the 0.5-voxel jitter margin
    # outside the grid the clipped cell's wall is behind the ray and the
    # hop would degenerate to its fp nudge (the 2026-08-19 stall).
    # Majorant lookup stays clipped — edge supervoxels are dilated to
    # cover the margin's reachable densities.
    svi_raw = jnp.floor(pos / S).astype(jnp.int32)
    svi = jnp.clip(svi_raw, 0, dims - 1)
    m_loc = _sv_lookup(vol, svi, ch)

    b_lo = svi_raw.astype(jnp.float32) * S
    bound = jnp.where(ld > 0.0, b_lo + S, b_lo)
    safe_d = jnp.where(jnp.abs(ld) < 1e-9, 1e-9, ld)
    t_ax = jnp.where(jnp.abs(ld) < 1e-9, jnp.inf, (bound - lo) / safe_d)
    # nudge past the boundary by >= 1e-3 voxel so fp rounding can't
    # re-enter the same supervoxel and stall the walk
    nudge = 1e-3 / jnp.maximum(jnp.max(jnp.abs(ld), -1), 1e-12)
    t_hop = jnp.maximum(t_ax.min(-1), t) + nudge

    dt = jnp.where(m_loc > 0.0,
                   -jnp.log1p(-u_flight) / jnp.maximum(m_loc, 1e-12),
                   jnp.inf)
    return m_loc, t + dt, t_hop


def _one_hot_tr(kind, tr, pdf, ch):
    """Mono -> uniform Tr; RGB -> one-hot Tr/pdf (volume.py:391-401)."""
    if kind == VolumeTag.RGB:
        oh = jax.nn.one_hot(ch, 3, dtype=jnp.float32)
        return oh * (tr / jnp.maximum(pdf, 1e-12))[:, None]
    return jnp.broadcast_to(tr[:, None], (tr.shape[0], 3))


# Compaction slice width as a fraction of the wavefront: the tracking
# loops' cost is per-lane density gathers, and typically only a small
# fraction of lanes even cross the volume AABB (10.9% of cbox-rgbvol
# camera rays, scripts/bench_volume.py). Crossing lanes are sorted to the
# front (one multi-operand lax.sort, ~1 ms at 262k) and the stochastic
# march runs on fixed (N/_COMPACT_DIV,)-wide slices, with a dynamic number
# of rounds — only ceil(M/C) slices of gathers are paid instead of N-wide
# gathers for every lane every step (8x on the tornado scene).
_COMPACT_DIV = 8
_COMPACT_MIN = 2048     # below this, slicing overhead beats the win


def _compact_rounds(crossing, inputs, outputs, round_fn):
    """Run round_fn on front-compacted fixed-width slices of the lanes
    where `crossing` is True.

    inputs: dict of (N,...)/(N,) arrays consumed by round_fn;
    outputs: dict of (N,...) defaults (returned unchanged for non-crossing
    lanes); round_fn(r, ins_slice, outs_slice, live) -> outs_slice, where
    `live` marks slice lanes that need the march.
    """
    N = crossing.shape[0]
    if N <= _COMPACT_MIN or DIFF_STEPS > 0:
        # differentiable mode skips compaction: its dynamic-round
        # while_loop has no reverse-mode rule (the march itself runs a
        # fixed-trip fori_loop there)
        return round_fn(jnp.int32(0), inputs, outputs, crossing)

    from .intersect import _sort_by, _unsort
    C = -(-N // _COMPACT_DIV)
    C = -(-C // 128) * 128                  # lane-aligned slice
    lane = jnp.arange(N, dtype=jnp.int32)
    key_order = jnp.where(crossing, 0, 1).astype(jnp.int32)
    # outputs ride the same sort as inputs so per-lane defaults stay with
    # their lane (treating original-order defaults as sorted-space would
    # silently hand lanes each other's state; today's callers pass
    # constants, but the contract allows e.g. a running throughput)
    vals = _sort_by(key_order, [inputs[k] for k in inputs]
                    + [outputs[k] for k in outputs] + [lane])
    ins_s = dict(zip(inputs, vals[:len(inputs)]))
    outs_s = dict(zip(outputs, vals[len(inputs):-1]))
    lane_s = vals[-1]
    m = jnp.sum(crossing.astype(jnp.int32))

    def cond(st):
        r, _ = st
        return r * C < m

    def body(st):
        r, outs = st
        off = r * C

        def sl(x):
            return jax.lax.dynamic_slice(
                x, (off,) + (0,) * (x.ndim - 1), (C,) + x.shape[1:])

        live = (off + jnp.arange(C, dtype=jnp.int32)) < m
        ins_r = {k: sl(v) for k, v in ins_s.items()}
        outs_r = {k: sl(v) for k, v in outs.items()}
        outs_r = round_fn(r, ins_r, outs_r, live)
        outs = {k: jax.lax.dynamic_update_slice(
            outs[k], outs_r[k], (off,) + (0,) * (outs[k].ndim - 1))
            for k in outs}
        return r + 1, outs

    # pad so fixed-width slices never read out of bounds
    total = -(-N // C) * C
    pad_n = total - N
    if pad_n:
        ins_s = {k: jnp.concatenate(
            [v, jnp.zeros((pad_n,) + v.shape[1:], v.dtype)]) for k, v in
            ins_s.items()}
        outs_s = {k: jnp.concatenate(
            [v, jnp.zeros((pad_n,) + v.shape[1:], v.dtype)]) for k, v in
            outs_s.items()}

    _, outs_s = jax.lax.while_loop(cond, body, (jnp.int32(0), outs_s))
    if pad_n:
        outs_s = {k: v[:N] for k, v in outs_s.items()}
    # restore original lane order
    restored = _unsort(lane_s, [outs_s[k] for k in outputs])
    return dict(zip(outputs, restored))


def sample_distance_delta_tracking(vol, kind, key, ray_o, ray_d, thp,
                                   max_t, active=None):
    """Spectral delta-tracking distance sample (volume.py:346-402).

    Returns (t, beta): t = collision distance or -1 (no volume event);
    beta multiplies throughput only where t > 0. Dead lanes (active
    False) are excluded from the compacted march entirely — at late
    bounces they would otherwise inflate the crossing count and buy
    extra rounds of per-lane density gathers."""
    N = ray_o.shape[0]
    lo, ld, near, far = _march_interval(vol, ray_o, ray_d, max_t)
    key, k_ch = jax.random.split(key)
    u_ch = jax.random.uniform(k_ch, (N,))
    ch, pdf, _maj = _pick_channel(vol, thp, u_ch)

    crossing = (near < far) & (far > 0.0)
    if active is not None:
        crossing &= active

    # sorted-space operands kept minimal (sort cost scales with payload);
    # per-channel constants rebuild from `ch` inside the round
    inputs = dict(lo=lo, ld=ld, near=near, far=far, ch=ch)
    outputs = dict(hit_t=jnp.full((N,), -1.0),
                   tr=jnp.ones((N,), jnp.float32))

    def round_fn(r, ins, outs, live):
        n = ins["near"].shape[0]
        alb = tgather(vol.albedo, ins["ch"])
        state = dict(t=ins["near"], tr=outs["tr"], hit_t=outs["hit_t"],
                     done=~live, step=jnp.int32(0))

        def cond(st):
            return (~jnp.all(st["done"])) & (st["step"] < MAX_STEPS)

        def body(st):
            # HOP-CHAIN (r5): advance up to VOL_HOPS supervoxel steps in
            # registers — each sub-step either freezes at this lane's
            # next collision CANDIDATE or hops an (empty/cheap) cell —
            # then ONE density gather resolves the frozen candidates.
            # The per-lane density gather now costs one n-wide pass per
            # OUTER iteration, and outer iterations ~ candidates +
            # hops/VOL_HOPS instead of candidates + hops. Hop sub-steps
            # touch only the one-hot sv-majorant lookup (no random
            # access).
            k = jax.random.fold_in(key, r * (MAX_STEPS + 1) + st["step"])
            u = jax.random.uniform(k, (n, VOL_HOPS + 4))
            t, exited = st["t"], st["done"]
            found = jnp.zeros((n,), bool)
            cand_t = t
            cand_m = jnp.zeros((n,), jnp.float32)
            for j in range(VOL_HOPS):
                m_loc, t_cand, t_hop = _sv_step(
                    vol, ins["lo"], ins["ld"], ins["ch"], t, u[:, j],
                    ins["far"])
                is_cand = (~exited) & (~found) \
                    & (t_cand <= jnp.minimum(t_hop, ins["far"]))
                cand_t = jnp.where(is_cand, t_cand, cand_t)
                cand_m = jnp.where(is_cand, m_loc, cand_m)
                found = found | is_cand
                move = ~(found | exited)
                t = jnp.where(move, t_hop, t)
                exited = exited | (move & (t >= ins["far"]))
            # fresh jitter + acceptance draws (independent of which
            # sub-step froze the candidate)
            pos = ins["lo"] + cand_t[:, None] * ins["ld"]
            ci, okb = _density_index(vol, pos, u[:, VOL_HOPS:VOL_HOPS + 3])
            (val,) = _gather_candidates(vol, ins["ch"], [ci],
                                        [okb & found])
            hit_t, tr = st["hit_t"], st["tr"]
            collide = found & (u[:, VOL_HOPS + 3]
                               * jnp.maximum(cand_m, 1e-12) < val)
            hit_t = jnp.where(collide, cand_t, hit_t)
            tr = jnp.where(collide, tr * alb, tr)
            # null candidates continue marching from the candidate point
            t = jnp.where(found, cand_t, t)
            done = st["done"] | collide | exited
            return dict(t=t, tr=tr, hit_t=hit_t, done=done,
                        step=st["step"] + 1)

        st = jax.lax.while_loop(cond, _unrolled(body), state)
        return dict(hit_t=st["hit_t"], tr=st["tr"])

    outs = _compact_rounds(crossing, inputs, outputs, round_fn)
    beta = _one_hot_tr(kind, outs["tr"], pdf, ch)
    has_hit = outs["hit_t"] > 0.0
    beta = jnp.where(has_hit[:, None], beta, 1.0)
    return outs["hit_t"], beta


def eval_tr_ratio_tracking(vol, kind, key, ray_o, ray_d, thp, max_t,
                           active=None):
    """Spectral ratio-tracking transmittance (volume.py:404-463).
    Dead lanes (active False) skip the march and return Tr = 1."""
    N = ray_o.shape[0]
    lo, ld, near, far = _march_interval(vol, ray_o, ray_d, max_t)
    key, k_ch = jax.random.split(key)
    u_ch = jax.random.uniform(k_ch, (N,))
    ch, pdf, _maj = _pick_channel(vol, thp, u_ch)

    crossing = (near < far) & (far > 0.0)
    if active is not None:
        crossing &= active
    inputs = dict(lo=lo, ld=ld, near=near, far=far, ch=ch)
    outputs = dict(tr=jnp.ones((N,), jnp.float32))

    def round_fn(r, ins, outs, live0):
        n = ins["near"].shape[0]
        state = dict(t=ins["near"], tr=outs["tr"], done=~live0,
                     step=jnp.int32(0))

        def cond(st):
            return (~jnp.all(st["done"])) & (st["step"] < MAX_STEPS)

        def body(st):
            # HOP-CHAIN (r5, see the delta-tracking body): freeze at the
            # next candidate within VOL_HOPS supervoxel steps, ONE
            # shared gather, then the ratio factor + tr-dependent RR of
            # the reference (volume.py:448-453) for the frozen candidate
            k = jax.random.fold_in(key, r * (MAX_STEPS + 1) + st["step"])
            u = jax.random.uniform(k, (n, VOL_HOPS + 4))
            t, exited = st["t"], st["done"]
            found = jnp.zeros((n,), bool)
            cand_t = t
            cand_m = jnp.zeros((n,), jnp.float32)
            for j in range(VOL_HOPS):
                m_loc, t_cand, t_hop = _sv_step(
                    vol, ins["lo"], ins["ld"], ins["ch"], t, u[:, j],
                    ins["far"])
                is_cand = (~exited) & (~found) \
                    & (t_cand <= jnp.minimum(t_hop, ins["far"]))
                cand_t = jnp.where(is_cand, t_cand, cand_t)
                cand_m = jnp.where(is_cand, m_loc, cand_m)
                found = found | is_cand
                move = ~(found | exited)
                t = jnp.where(move, t_hop, t)
                exited = exited | (move & (t >= ins["far"]))
            pos = ins["lo"] + cand_t[:, None] * ins["ld"]
            ci, okb = _density_index(vol, pos, u[:, VOL_HOPS:VOL_HOPS + 3])
            (val,) = _gather_candidates(vol, ins["ch"], [ci],
                                        [okb & found])
            tr = st["tr"]
            # ratio factor at the LOCAL rate; hop steps leave tr alone
            # (exact: piecewise-constant-majorant tracking)
            tr = jnp.where(found, tr * jnp.maximum(
                0.0, 1.0 - val / jnp.maximum(cand_m, 1e-12)), tr)
            rr = found & (tr < 0.1)
            killed = rr & (u[:, VOL_HOPS + 3] >= tr)
            tr = jnp.where(killed, 0.0, jnp.where(rr, 1.0, tr))
            t = jnp.where(found, cand_t, t)
            done = st["done"] | exited | killed
            return dict(t=t, tr=tr, done=done, step=st["step"] + 1)

        if DIFF_STEPS > 0:
            st = jax.lax.fori_loop(0, DIFF_STEPS, lambda i, s: body(s),
                                   state)
        else:
            st = jax.lax.while_loop(cond, _unrolled(body), state)
        return dict(tr=st["tr"])

    outs = _compact_rounds(crossing, inputs, outputs, round_fn)
    tr3 = _one_hot_tr(kind, outs["tr"], pdf, ch)
    return jnp.where(crossing[:, None], tr3, 1.0)
