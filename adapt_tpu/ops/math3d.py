"""Vectorized 3D math for ray batches (device side, jnp).

All functions operate on (..., 3) arrays and are jit/vmap-friendly.
Rotation conventions follow the reference's Rodrigues construction
(la/cam_transform.py:51-105) so tangent frames match for anisotropic BxDFs.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from scipy.spatial.transform import Rotation as Rot

EPS = 1e-7
AXIS_Y = jnp.array([0.0, 1.0, 0.0], jnp.float32)


def dot(a, b, keepdims=False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def normalize(v, eps=1e-12):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), eps)


def norm(v, keepdims=False):
    return jnp.linalg.norm(v, axis=-1, keepdims=keepdims)


def safe_normalize(v, eps=1e-12):
    """normalize() with a grad-safe zero-vector branch.

    jnp.linalg.norm has a NaN reverse-mode gradient at v=0 (d|v|/dv =
    v/|v| -> 0/0); a where() that masks the FORWARD value downstream does
    not stop that NaN cotangent (JAX differentiates both branches), so a
    single zero-axis lane — e.g. the (anti)parallel Rodrigues fallback on
    every ceiling hit — poisons jax.grad of the whole image. The n2==0
    branch below substitutes a constant denominator, whose gradient is 0.
    Forward values are bit-identical to normalize() for nonzero v."""
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    n = jnp.sqrt(jnp.where(n2 == 0.0, 1.0, n2))
    return v / jnp.maximum(n, eps)


def rotation_between(fixed, target):
    """Batched Rodrigues rotation taking `fixed` to `target` (both unit).

    Returns (..., 3, 3). Matches reference la/cam_transform.py:51-68: the skew
    term uses the unnormalized cross product (|axis| = sin(theta)); near
    (anti)parallel inputs fall back to +/- identity.
    """
    fixed = jnp.broadcast_to(fixed, target.shape)
    axis = jnp.cross(fixed, target)                        # |axis| = sin
    cos_t = dot(fixed, target)[..., None, None]
    axis_n = safe_normalize(axis)   # grad-safe: axis=0 on parallel lanes
    eye = jnp.eye(3, dtype=target.dtype)
    outer = axis_n[..., :, None] * axis_n[..., None, :]
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = jnp.zeros_like(ax)
    skew = jnp.stack([
        jnp.stack([zeros, -az, ay], axis=-1),
        jnp.stack([az, zeros, -ax], axis=-1),
        jnp.stack([-ay, ax, zeros], axis=-1),
    ], axis=-2)
    rot = cos_t * eye + (1.0 - cos_t) * outer + skew
    parallel = jnp.abs(cos_t) >= 1.0 - 1e-5
    fallback = jnp.sign(cos_t) * eye
    return jnp.where(parallel, fallback, rot)


def rotation_from_y(target):
    """rotation_between([0,1,0], target) — the common tangent-frame case."""
    return rotation_between(AXIS_Y, target)


def rotate_between_apply(fixed, target, v):
    """Apply the Rodrigues rotation taking `fixed` to `target` directly to
    vector(s) v, without materializing (N,3,3) matrices.

    Building rotation matrices and batch-matvec'ing them lowers to
    (N,3,3)x(N,3) dot_generals, a poor shape at wavefront batch sizes;
    v' = v cos + (axis x v) + k (k.v)(1-cos) is pure elementwise.
    Matches rotation_between (la/cam_transform.py:51-68) incl. the +/-v
    fallback at (anti)parallel inputs."""
    fixed = jnp.broadcast_to(fixed, target.shape)
    axis = jnp.cross(fixed, target)          # |axis| = sin(theta)
    cos_t = dot(fixed, target, keepdims=True)
    k = safe_normalize(axis)        # grad-safe: axis=0 on parallel lanes
    out = (v * cos_t + jnp.cross(axis, v)
           + k * dot(k, v, keepdims=True) * (1.0 - cos_t))
    parallel = jnp.abs(cos_t) >= 1.0 - 1e-5
    return jnp.where(parallel, jnp.sign(cos_t) * v, out)


def delocalize_rotate(anchor, local_dir):
    """Local (y-up) frame -> global frame around `anchor`.

    Reference: la/cam_transform.py:89-93."""
    return rotate_between_apply(AXIS_Y, anchor, local_dir)


def localize_rotate(anchor, global_dir):
    """Global frame -> local y-up frame of `anchor`
    (reference la/cam_transform.py:95-99)."""
    return rotate_between_apply(anchor,
                                jnp.broadcast_to(AXIS_Y, anchor.shape),
                                global_dir)


def world_frame(local_anchor, global_anchor, local_dir):
    """Rotate `local_dir` by the rotation taking local_anchor->global_anchor
    (reference la/cam_transform.py:101-105)."""
    return rotate_between_apply(local_anchor, global_anchor, local_dir)


def convert_to_raw(d_in, normal):
    """Direction -> (cos_theta, sin_theta, cos_phi, sin_phi) in the normal's
    local frame (reference la/cam_transform.py:70-87). Returns (..., 4)."""
    local_dir = localize_rotate(normal, d_in)
    cos_theta = local_dir[..., 1]
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    safe = sin_theta > 1e-5
    inv_sin = jnp.where(safe, 1.0 / jnp.maximum(sin_theta, 1e-12), 0.0)
    cos_phi = jnp.where(safe, local_dir[..., 0] * inv_sin, 1.0)
    sin_phi = jnp.where(safe, local_dir[..., 2] * inv_sin, 0.0)
    return jnp.stack([cos_theta, sin_theta, cos_phi, sin_phi], axis=-1)


def np_rotation_between(fixed: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Host-side camera rotation with roll elimination
    (reference la/cam_transform.py:32-49).

    Near-antiparallel inputs get a proper pi rotation about the up-most
    axis perpendicular to `fixed` (NOT -identity, which is a mirror with
    det=-1 that flips the film on both axes — reachable interactively by
    yawing the scene_viz flythrough ~180 degrees)."""
    d = float(np.dot(fixed, target))
    if d > 1.0 - 1e-5:
        return np.eye(3, dtype=np.float32)
    if d < -1.0 + 1e-5:
        up = np.float64([0.0, 1.0, 0.0])
        axis = up - np.float64(fixed) * np.dot(fixed, up)
        if np.linalg.norm(axis) < 1e-6:      # fixed is (anti)parallel to up
            ex = np.float64([1.0, 0.0, 0.0])
            axis = ex - np.float64(fixed) * np.dot(fixed, ex)
        axis = axis / np.linalg.norm(axis) * np.pi
    else:
        axis = np.cross(fixed, target).astype(np.float64)
        axis /= np.linalg.norm(axis)
        axis *= np.arccos(d)
    euler = Rot.from_rotvec(axis).as_euler("zxy")
    euler[0] = 0.0  # eliminate roll
    return Rot.from_euler("zxy", euler).as_matrix().astype(np.float32)


def fov2focal(fov_deg: float, img_size: float) -> float:
    """Pinhole focal length in pixels (reference la/cam_transform.py:20-22)."""
    fov = fov_deg / 180.0 * np.pi
    return 0.5 * img_size / np.tan(0.5 * fov)
