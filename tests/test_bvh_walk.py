"""The stackless BVH walk (ops/bvh.py, every scene above 256 prims on the
GPU) against the brute-force jnp chunk scan: closest hit and any hit,
with and without max_t clipping and alive masks, on a 2k-triangle knot
with a sphere, the cornell box, and a scene mixing spheres and triangles.

Small scenes get no BVH by default; the fixture lowers the build
threshold so the walk runs over their prims too.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from adapt_tpu.scene import compile as scene_compile
from adapt_tpu.ops.intersect import ray_intersect, does_intersect, FAR

from conftest import SCENE_DIR, ensure_procedural

SCENES = {
    "knot2k": ("cbox", "knot2k-test.xml"),        # 2,010 tris + a sphere
    "cbox": ("cbox", "cbox.xml"),                 # 34 tris
    "balls": ("csphere", "balls-multi.xml"),      # 12 tris + 6 spheres
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def walk_scene(request):
    folder, xml = SCENES[request.param]
    if request.param == "knot2k":
        ensure_procedural("knot2k")
    mp = pytest.MonkeyPatch()
    mp.setattr(scene_compile, "BVH_THRESHOLD", 1)   # build for any size
    try:
        scene, cfg, _ = scene_compile.load_scene(SCENE_DIR + f"/{folder}/",
                                                 xml)
    finally:
        mp.undo()
    assert scene.bvh_node_pack.shape[0] > 1, "BVH not built"
    walk = dataclasses.replace(cfg, use_bvh=True, use_pallas=False)
    scan = dataclasses.replace(cfg, use_bvh=False, use_pallas=False)
    return request.param, scene, walk, scan


def _rays(scene, n, seed, clipped):
    rng = np.random.RandomState(seed)
    lo = np.asarray(scene.obj_aabb_min).min(0)
    hi = np.asarray(scene.obj_aabb_max).max(0)
    o = rng.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if not clipped:
        return jnp.asarray(o), jnp.asarray(d), None, None
    ext = float(np.linalg.norm(hi - lo))
    max_t = rng.uniform(0.05, 0.6, n).astype(np.float32) * ext
    alive = np.arange(n) % 3 != 0
    return (jnp.asarray(o), jnp.asarray(d), jnp.asarray(max_t),
            jnp.asarray(alive))


@pytest.mark.parametrize("clipped", [False, True], ids=["open", "clip"])
def test_walk_closest_hit_matches_scan(walk_scene, clipped):
    name, scene, walk, scan = walk_scene
    o, d, max_t, alive = _rays(scene, 512, 3, clipped)
    it_w = ray_intersect(scene, walk, o, d, max_t=max_t, alive=alive)
    it_s = ray_intersect(scene, scan, o, d, max_t=max_t, alive=alive)
    hit_w, hit_s = np.asarray(it_w.is_hit), np.asarray(it_s.is_hit)
    # hit/miss may flip only on a grazing edge (the leaf test computes
    # u, v from the hit point, the scan from o.U + t d.U)
    assert (hit_w != hit_s).mean() <= 2 / 512, name
    both = hit_w & hit_s
    assert both.sum() > 50, name
    np.testing.assert_allclose(np.asarray(it_w.t)[both],
                               np.asarray(it_s.t)[both], rtol=1e-5,
                               atol=1e-5)
    # prim ids may differ only on ties at equal t (the t check above):
    # a quad's two triangles share a diagonal, coplanar parts share edges
    same = np.asarray(it_w.prim_id)[both] == np.asarray(it_s.prim_id)[both]
    assert same.mean() > 0.95, name
    if clipped:
        dead = ~np.asarray(alive)
        assert not hit_w[dead].any()
        assert (np.asarray(it_w.t)[hit_w]
                < np.asarray(max_t)[hit_w]).all()
    else:
        # misses report t = FAR
        assert (np.asarray(it_w.t)[~hit_w] == np.float32(FAR)).all()


@pytest.mark.parametrize("clipped", [False, True], ids=["open", "clip"])
def test_walk_any_hit_matches_scan(walk_scene, clipped):
    name, scene, walk, scan = walk_scene
    o, d, max_t, alive = _rays(scene, 512, 5, clipped)
    if max_t is None:
        max_t = jnp.full((512,), 3.0)
    occ_w = np.asarray(does_intersect(scene, walk, o, d, max_t,
                                      alive=alive))
    occ_s = np.asarray(does_intersect(scene, scan, o, d, max_t,
                                      alive=alive))
    assert (occ_w != occ_s).mean() <= 2 / 512, name
    assert occ_s.any() and not occ_s.all(), name
    if alive is not None:
        assert not occ_w[~np.asarray(alive)].any()
