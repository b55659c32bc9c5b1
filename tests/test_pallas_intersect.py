"""Pallas (Triton route) triangle kernels == the jnp chunk scan.

Runs the kernels in interpret mode (the tests are on the CPU backend; the
Triton route compiles only for a CUDA card, where chip_smoke.py and the
gpu-marked test below check them) over cbox primary rays and random ray
batches, including max_t-clipped shadow rays and ragged shapes. The
kernel uses the scan's op order, so on the CPU hits agree exactly and
floats to ~1 ULP.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from adapt_tpu.scene.compile import load_scene
from adapt_tpu.ops import intersect_pallas
from adapt_tpu.ops.intersect import ray_intersect, does_intersect, FAR
from adapt_tpu.renderer.base import camera_rays

from conftest import SCENE_DIR


@pytest.fixture(scope="module", autouse=True)
def interpret_mode():
    old = intersect_pallas._INTERPRET
    intersect_pallas._INTERPRET = True
    yield
    intersect_pallas._INTERPRET = old


@pytest.fixture(scope="module")
def cbox():
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "cbox.xml")
    cfg = dataclasses.replace(
        cfg, w=32, h=32, focal=cfg.focal * 32 / 512, end_x=32, end_y=32,
        anti_alias=False, stratified_sampling=False)
    return scene, cfg


def _tiers(cfg):
    return (dataclasses.replace(cfg, use_pallas=False, use_bvh=False),
            dataclasses.replace(cfg, use_pallas=True, use_bvh=False))


def _rays(scene, cfg, key):
    ro, rd = camera_rays(scene, cfg, jax.random.PRNGKey(0), jnp.int32(0))
    # add random interior rays: origins jittered off the camera ray hits
    k1, k2 = jax.random.split(key)
    t = jax.random.uniform(k1, (ro.shape[0], 1), minval=0.1, maxval=2.0)
    o2 = ro + rd * t
    d2 = jax.random.normal(k2, rd.shape)
    d2 = d2 / jnp.linalg.norm(d2, axis=-1, keepdims=True)
    return (jnp.concatenate([ro, o2], 0), jnp.concatenate([rd, d2], 0))


def _assert_same_hits(got, ref):
    # hit decisions must agree exactly; float fields may differ by FMA
    # rounding (differently-fused programs), so allow ~1 ULP
    assert (np.asarray(got.obj_id) == np.asarray(ref.obj_id)).all()
    assert (np.asarray(got.prim_id) == np.asarray(ref.prim_id)).all()
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=2e-6)
    np.testing.assert_allclose(np.asarray(got.uv), np.asarray(ref.uv),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(np.asarray(got.n_g), np.asarray(ref.n_g))


def test_closest_hit_matches_scan(cbox):
    scene, cfg = cbox
    ro, rd = _rays(scene, cfg, jax.random.PRNGKey(5))
    scan, kern = _tiers(cfg)
    _assert_same_hits(ray_intersect(scene, kern, ro, rd),
                      ray_intersect(scene, scan, ro, rd))


def test_any_hit_matches_scan(cbox):
    scene, cfg = cbox
    ro, rd = _rays(scene, cfg, jax.random.PRNGKey(11))
    scan, kern = _tiers(cfg)
    # unclipped and max_t-clipped (shadow-ray form)
    for max_t in (None, jnp.full((ro.shape[0],), 1.5, jnp.float32)):
        ref = does_intersect(scene, scan, ro, rd, max_t)
        got = does_intersect(scene, kern, ro, rd, max_t)
        assert (np.asarray(got) == np.asarray(ref)).all()


def test_nonmultiple_batch_and_sphere_combine():
    """Ray counts not divisible by BLOCK, and a scene with spheres."""
    scene, cfg, _ = load_scene(SCENE_DIR + "/csphere/", "single-ball.xml")
    cfg = dataclasses.replace(
        cfg, w=17, h=13, focal=cfg.focal * 17 / 512, end_x=17, end_y=13,
        anti_alias=False, stratified_sampling=False)
    ro, rd = camera_rays(scene, cfg, jax.random.PRNGKey(0), jnp.int32(0))
    assert ro.shape[0] % intersect_pallas.BLOCK
    scan, kern = _tiers(cfg)
    ref = ray_intersect(scene, scan, ro, rd)
    got = ray_intersect(scene, kern, ro, rd)
    assert (np.asarray(got.obj_id) == np.asarray(ref.obj_id)).all()
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=2e-6)


def _subscene(scene, rows):
    """The scene restricted to the triangle rows `rows` (ragged T)."""
    rows = jnp.asarray(rows)
    return dataclasses.replace(
        scene, tri_gid=scene.tri_gid[rows], tri_obj=scene.tri_obj[rows],
        tri_n=scene.tri_n[rows], tri_d=scene.tri_d[rows],
        tri_U=scene.tri_U[rows], tri_V=scene.tri_V[rows],
        tri_cu=scene.tri_cu[rows], tri_cv=scene.tri_cv[rows])


@pytest.mark.parametrize("n_rays,n_tris", [
    (1, 34),            # a single ray: one padded block
    (129, 34),          # one past a block
    (300, 1),           # a one-row table
    (257, 7),           # T unrelated to the block
    (200, 33),          # T one short of the scene
])
def test_kernel_ragged_shapes(cbox, n_rays, n_tris):
    scene, cfg = cbox
    sub = _subscene(scene, np.arange(n_tris))
    ro, rd = _rays(scene, cfg, jax.random.PRNGKey(n_rays))
    ro, rd = ro[:n_rays], rd[:n_rays]
    far = jnp.full((n_rays,), FAR, jnp.float32)
    t, gid, u, v, ng, obj = intersect_pallas.tri_closest_hit(sub, ro, rd,
                                                            far)
    assert t.shape == (n_rays,) and ng.shape == (n_rays, 3)
    scan, _kern = _tiers(cfg)
    ref = ray_intersect(sub, scan, ro, rd)
    hit = np.asarray(ref.obj_id) >= 0
    np.testing.assert_array_equal(np.asarray(gid),
                                  np.where(hit, np.asarray(ref.prim_id), -1))
    np.testing.assert_array_equal(np.asarray(obj), np.asarray(ref.obj_id))
    np.testing.assert_allclose(np.asarray(t), np.asarray(ref.t), rtol=2e-6)
    occ = intersect_pallas.tri_any_hit(sub, ro, rd, far)
    np.testing.assert_array_equal(np.asarray(occ), hit)


def test_kernel_all_miss_and_far_clip(cbox):
    """Rays pointing away from every triangle miss with the documented
    defaults; a far clip below every hit turns hits into misses, and a
    dead lane (far = -3e38) never hits."""
    scene, cfg = cbox
    lo = np.asarray(scene.obj_aabb_min).min(0)
    n = 130
    ro = jnp.broadcast_to(jnp.asarray(lo - 10.0), (n, 3))
    rd = jnp.broadcast_to(jnp.asarray([-1.0, 0.0, 0.0]), (n, 3))
    far = jnp.full((n,), FAR, jnp.float32)
    t, gid, u, v, ng, obj = intersect_pallas.tri_closest_hit(scene, ro, rd,
                                                            far)
    assert (np.asarray(gid) == -1).all() and (np.asarray(obj) == -1).all()
    np.testing.assert_array_equal(np.asarray(t), np.asarray(far))
    np.testing.assert_array_equal(np.asarray(ng),
                                  np.tile([1.0, 0.0, 0.0], (n, 1)))
    assert not np.asarray(intersect_pallas.tri_any_hit(scene, ro, rd,
                                                       far)).any()

    ro2, rd2 = _rays(scene, cfg, jax.random.PRNGKey(3))
    m = ro2.shape[0]
    t_hit = np.asarray(intersect_pallas.tri_closest_hit(
        scene, ro2, rd2, jnp.full((m,), FAR, jnp.float32))[0])
    clip = jnp.asarray(np.where(t_hit < FAR, t_hit * 0.5, 1.0),
                       jnp.float32)
    clip = jnp.where(jnp.arange(m) % 3 == 0, -3e38, clip)
    t2, gid2, *_ = intersect_pallas.tri_closest_hit(scene, ro2, rd2, clip)
    assert (np.asarray(gid2) == -1).all()
    np.testing.assert_array_equal(np.asarray(t2), np.asarray(clip))
    assert not np.asarray(intersect_pallas.tri_any_hit(scene, ro2, rd2,
                                                       clip)).any()


@pytest.mark.gpu
def test_kernel_matches_jnp_on_card(gpu_device, cbox, monkeypatch):
    """The kernel compiled for the card (no interpret mode) against the
    jnp chunk scan, at chip_smoke's tolerances."""
    import chip_smoke
    monkeypatch.setattr(intersect_pallas, "_INTERPRET", False)
    scene, cfg = cbox
    with jax.default_device(gpu_device):
        out = chip_smoke.kernel_check(scene, cfg, 64 * 64)
    assert out["hits"] > 0
