"""Which intersector a scene takes (scene/compile.choose_intersector): a
pure function of the backend, the triangle count and the prim count."""
import pytest

from adapt_tpu.scene.compile import (choose_intersector, BVH_THRESHOLD,
                                     SMALL_SCENE_PRIMS)


@pytest.mark.parametrize("backend,n_tris,n_prims,expected", [
    # the GPU: the Triton kernel for small triangle scenes, the jnp scan
    # for small sphere-only scenes, the BVH walk above SMALL_SCENE_PRIMS
    ("gpu", 34, 34, "pallas"),                       # cbox
    ("gpu", 12, 18, "pallas"),                       # tris + spheres
    ("gpu", 0, 6, "scan"),                           # spheres only
    ("gpu", SMALL_SCENE_PRIMS, SMALL_SCENE_PRIMS, "pallas"),
    ("gpu", SMALL_SCENE_PRIMS, SMALL_SCENE_PRIMS + 1, "bvh"),
    ("gpu", 290010, 290010, "bvh"),                  # knot290k
    # the CPU: the chunk scan below BVH_THRESHOLD prims, the walk above
    ("cpu", 34, 34, "scan"),
    ("cpu", BVH_THRESHOLD - 1, BVH_THRESHOLD - 1, "scan"),
    ("cpu", BVH_THRESHOLD, BVH_THRESHOLD, "bvh"),
    ("cpu", 2010, 2011, "bvh"),
])
def test_choose_intersector(backend, n_tris, n_prims, expected):
    assert choose_intersector(backend, n_tris, n_prims) == expected


@pytest.mark.parametrize("backend", ["rocm", "METAL", "xpu"])
def test_choose_intersector_unknown_backend_raises(backend):
    with pytest.raises(ValueError, match="no intersector"):
        choose_intersector(backend, 34, 34)


def test_compiled_cbox_on_cpu_uses_scan():
    """load_scene applies the choice for the running backend (CPU here)."""
    from adapt_tpu.scene.compile import load_scene
    from conftest import SCENE_DIR
    _scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "cbox.xml")
    assert not cfg.use_bvh and not cfg.use_pallas
