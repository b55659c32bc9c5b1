"""VPT's sequential media walk (renderer/vpt.py _track_loop, reached
through track_ray) against a numpy Beer-Lambert oracle.

Rays run along +x through axis-aligned null-BSDF boxes filled with
homogeneous media: the oracle intersects each box analytically (slab
test), so Tr = exp(-sum_k sigma_e_k L_k) and the ior-weighted time is
sum_k ior_k L_k + (free length) * world ior. Cases cover separated boxes,
boxes layered exactly RAY_EPS apart (the vpt cbox convention: a null box
1e-4 above the floor), a ray starting inside a medium, an opaque blocker,
and rays that miss everything. (A target inside a medium is left out on
purpose: like the reference's walk, the last segment after a miss counts
as free space.)
"""
import numpy as np
import jax.numpy as jnp
import pytest

from adapt_tpu.scene.compile import load_scene
from adapt_tpu.ops.intersect import RAY_EPS
from adapt_tpu.renderer.vpt import track_ray

MEDIA = {"boxA": (0.7 + 0.9, 1.0), "boxB": (0.2 + 1.6, 1.2)}  # (sigma_e, ior)


def _cube_obj(x0, x1, y0=0.0, y1=1.0, z0=0.0, z1=1.0):
    """Axis-aligned box OBJ text with outward-facing windings."""
    vs = [(x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
          (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)]
    quads = [(4, 3, 2, 1),         # z=z0, normal -z
             (5, 6, 7, 8),         # z=z1, normal +z
             (1, 5, 8, 4),         # x=x0, normal -x
             (2, 3, 7, 6),         # x=x1, normal +x
             (1, 2, 6, 5),         # y=y0, normal -y
             (4, 8, 7, 3)]         # y=y1, normal +y
    v = np.asarray(vs)
    ctr = v.mean(0)
    lines = [f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}" for p in vs]
    for a, b, c, d in quads:
        n = np.cross(v[b - 1] - v[a - 1], v[c - 1] - v[a - 1])
        assert np.dot(n, v[a - 1] - ctr) > 0      # outward winding
        lines += [f"f {a} {b} {c}", f"f {a} {c} {d}"]
    return "\n".join(lines) + "\n"


def _scene_xml(with_blocker):
    blocker = """
  <brdf type="lambertian" id="wall">
    <rgb name="k_d" value="0.5"/>
  </brdf>
  <shape type="obj">
    <string name="filename" value="wall.obj"/>
    <ref type="material" id="wall"/>
  </shape>""" if with_blocker else ""
    media = "".join(f"""
  <bsdf type="null" id="{m}">
    <medium type="hg">
      <rgb name="u_a" value="{ua}"/>
      <rgb name="u_s" value="{us}"/>
      <rgb name="par" value="0.0"/>
      <float name="ior" value="{ior}"/>
    </medium>
  </bsdf>
  <shape type="obj">
    <string name="filename" value="{m}.obj"/>
    <ref type="material" id="{m}"/>
  </shape>""" for m, ua, us, ior in (("boxA", 0.7, 0.9, 1.0),
                                      ("boxB", 0.2, 1.6, 1.2)))
    return f"""<?xml version='1.0' encoding='utf-8'?>
<scene version="1.1">
  <sensor type="perspective">
    <float name="fov" value="40"/>
    <integer name="sample_count" value="1"/>
    <integer name="max_bounce" value="4"/>
    <transform name="toWorld">
      <lookat target="1.5, 0.5, 0.5" origin="-2, 0.5, 0.5" up="0, 1, 0"/>
    </transform>
    <film type="film">
      <integer name="width" value="8"/>
      <integer name="height" value="8"/>
    </film>
  </sensor>
  <emitter type="point" id="point">
    <rgb name="emission" value="10.0, 10.0, 10.0"/>
    <point name="center" x="0.5" y="3.0" z="0.5"/>
  </emitter>{media}{blocker}
  <world name="w">
    <rgb name="skybox" value="0.0"/>
    <rgb name="ambient" value="0.0"/>
  </world>
</scene>
"""


# name -> (boxB's x range, opaque wall's x range or None, ray origin x,
#          rays miss the boxes)
CASES = {
    "separated": ((1.3, 2.0), None, -0.5, False),
    "eps_layered": ((1.0 + RAY_EPS, 2.0), None, -0.5, False),
    "origin_inside": ((1.3, 2.0), None, 0.4, False),
    "blocked": ((1.3, 2.0), (2.5, 3.0), -0.5, False),
    "miss": ((1.3, 2.0), None, -0.5, True),
}


def _slab(o, d, lo, hi):
    """Entry/exit distances of rays (n,3) through the box [lo, hi]."""
    inv = 1.0 / d
    t1 = (np.asarray(lo) - o) * inv
    t2 = (np.asarray(hi) - o) * inv
    return np.minimum(t1, t2).max(-1), np.maximum(t1, t2).min(-1)


def _oracle(o, d, depth, boxes, wall):
    """Beer-Lambert Tr (n,3) and ior-weighted time (n,) along each ray."""
    end = depth.copy()
    if wall is not None:
        t0, t1 = _slab(o, d, *wall)
        blocked = (t1 >= t0) & (t0 > 0) & (t0 < depth)
        end = np.where(blocked, t0, end)
    else:
        blocked = np.zeros(len(o), bool)
    tau = np.zeros(len(o))
    inside = np.zeros(len(o))
    acc = np.zeros(len(o))
    for name, (lo, hi) in boxes.items():
        t0, t1 = _slab(o, d, lo, hi)
        length = np.clip(np.minimum(t1, end) - np.maximum(t0, 0.0), 0.0,
                         None)
        sigma, ior = MEDIA[name]
        tau += sigma * length
        inside += length
        acc += ior * length
    acc += end - inside                       # free space, world ior 1
    tr = np.where(blocked, 0.0, np.exp(-tau))
    return np.repeat(tr[:, None], 3, 1), acc


@pytest.mark.parametrize("case", sorted(CASES))
def test_track_loop_matches_beer_lambert(tmp_path, case):
    b_range, wall, x0, miss = CASES[case]
    boxes = {"boxA": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
             "boxB": ((b_range[0], 0.0, 0.0), (b_range[1], 1.0, 1.0))}
    (tmp_path / "boxA.obj").write_text(_cube_obj(0.0, 1.0))
    (tmp_path / "boxB.obj").write_text(_cube_obj(*b_range))
    walls = None
    if wall is not None:
        (tmp_path / "wall.obj").write_text(_cube_obj(*wall))
        walls = ((wall[0], 0.0, 0.0), (wall[1], 1.0, 1.0))
    (tmp_path / "scene.xml").write_text(_scene_xml(wall is not None))
    scene, cfg, _ = load_scene(str(tmp_path), "scene.xml")
    assert cfg.has_null_bsdf

    # rays along +x, slightly tilted so every gap is crossed at an angle;
    # the tilt keeps them inside the boxes' y/z extent
    n = 64
    rng = np.random.default_rng(23)
    y0 = 1.7 if miss else 0.5
    o = np.stack([np.full(n, x0), rng.uniform(y0 - 0.2, y0 + 0.2, n),
                  rng.uniform(0.3, 0.7, n)], -1).astype(np.float32)
    d = np.stack([np.ones(n), rng.uniform(-0.05, 0.05, n),
                  rng.uniform(-0.05, 0.05, n)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    depth = np.full(n, 4.0, np.float32)

    tr, acc = track_ray(scene, cfg, jnp.asarray(o), jnp.asarray(d),
                        jnp.asarray(depth))
    tr_ref, acc_ref = _oracle(o.astype(np.float64), d.astype(np.float64),
                              depth.astype(np.float64), boxes, walls)
    np.testing.assert_allclose(np.asarray(tr), tr_ref, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(acc), acc_ref, rtol=1e-4,
                               atol=1e-4)
    if case == "blocked":
        assert (np.asarray(tr) == 0.0).all()
    elif case == "miss":
        np.testing.assert_array_equal(np.asarray(tr), 1.0)
    else:
        assert (np.asarray(tr) < 1.0).all()
