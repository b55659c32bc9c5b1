"""Small-table lookups as one-hot contractions instead of gather ops.

The renderer was first built for an accelerator where per-lane gathers
were slow and one-hot matmuls fast. Whether plain `table[idx]` is faster
on the GPU is an open measurement (ROADMAP A4); until then every lookup
of a small table goes through here.

Exactness: one-hot weights are 0.0/1.0 and each output is 1.0 * value +
zeros, so the contraction reproduces table values bit-exactly as long as
the matmul runs in full f32: the package pins
jax_default_matmul_precision=highest (adapt_tpu/__init__.py), because a
TF32 matmul would keep only 10 mantissa bits. Integer tables go through
f32, exact for |v| < 2^24.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

ONE_HOT_MAX = 192      # beyond this, plain gathers


def tgather_pack(tables, idx):
    """Shared-one-hot gather: tables[k][idx] for several (P, ...) tables.

    Builds the (N, P) one-hot ONCE and contracts against the concatenated
    feature columns in a single matmul, instead of one materialized
    one-hot + matmul per table. Bool tables return via >0.5, ints via
    rint (exact below 2^24), like tgather."""
    P = tables[0].shape[0]
    assert all(t.shape[0] == P for t in tables)
    if P > ONE_HOT_MAX:
        return [t[idx] for t in tables]
    flats = [t.reshape(P, -1).astype(jnp.float32) for t in tables]
    widths = [f.shape[1] for f in flats]
    oh = (idx[:, None] == jnp.arange(P, dtype=idx.dtype)[None, :]) \
        .astype(jnp.float32)
    packed = oh @ jnp.concatenate(flats, axis=1)        # (N, sum F)
    outs = []
    off = 0
    for t, w in zip(tables, widths):
        col = packed[:, off:off + w].reshape(idx.shape + t.shape[1:])
        if t.dtype == jnp.bool_:
            col = col > 0.5
        elif t.dtype != jnp.float32:
            col = jnp.rint(col).astype(t.dtype)
        outs.append(col)
        off += w
    return outs


def tgather(table, idx):
    """table[idx] for a (P, ...) table and (N,) int indices.

    One-hot contraction when P is small (wavefront-friendly), plain gather
    otherwise. Out-of-range indices must be pre-clamped by the caller (same
    contract as table[idx])."""
    P = table.shape[0]
    if P > ONE_HOT_MAX:
        return table[idx]
    oh = (idx[:, None] == jnp.arange(P, dtype=idx.dtype)[None, :]) \
        .astype(jnp.float32)
    flat = table.reshape(P, -1)
    if table.dtype == jnp.float32:
        out = oh @ flat
    elif table.dtype == jnp.bool_:
        out = (oh @ flat.astype(jnp.float32)) > 0.5
    else:  # integer tables (ids fit f32 exactly below 2^24)
        out = jnp.rint(oh @ flat.astype(jnp.float32)).astype(table.dtype)
    return out.reshape(idx.shape + table.shape[1:])


def select_along(values, idx):
    """take_along_axis(values, idx[:, None], 1)[:, 0] for (N, C) values,
    as a one-hot reduction (VPU) instead of a per-lane gather."""
    C = values.shape[1]
    oh = idx[:, None] == jnp.arange(C, dtype=idx.dtype)[None, :]
    if values.dtype == jnp.bool_:
        return jnp.any(values & oh, axis=1)
    return jnp.sum(jnp.where(oh, values, 0), axis=1)
