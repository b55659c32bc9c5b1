#!/usr/bin/env python
"""Generate procedural stand-in meshes for the reference's unshipped assets.

The reference benchmarks cite bunny (~90k prims) and sports-car (~290k
prims) meshes that its repo does not ship (external downloads). This writes
parametric torus-knot tube meshes of comparable triangle counts so the BVH
traversal path can be exercised and benchmarked at reference scale:

    scenes/meshes/procedural/knot90k.obj    (~90k tris)
    scenes/meshes/procedural/knot290k.obj   (~290k tris)

Meshes are deterministic; files are regenerated only if absent.

    python scripts/gen_procedural.py                  # every asset
    python scripts/gen_procedural.py knot2k tornado   # named ones (ENSURE)

The named assets need numpy alone; the full set also writes image
textures, which needs PIL.
"""
import os
import sys

import numpy as np


def torus_knot(n_u, n_v, p=2, q=3, R=1.0, r=0.35, tube=0.18):
    """Closed tube around a (p,q) torus knot; returns (verts, faces)."""
    u = np.linspace(0.0, 2.0 * np.pi, n_u, endpoint=False)
    # center curve
    cu = (R + r * np.cos(q * u))
    c = np.stack([cu * np.cos(p * u), cu * np.sin(p * u),
                  -r * np.sin(q * u)], axis=1)
    # frame via finite differences
    t = np.roll(c, -1, axis=0) - np.roll(c, 1, axis=0)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    ref = np.array([0.0, 0.0, 1.0])
    n = np.cross(t, ref)
    bad = np.linalg.norm(n, axis=1) < 1e-6
    n[bad] = np.cross(t[bad], np.array([1.0, 0.0, 0.0]))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    b = np.cross(t, n)

    v = np.linspace(0.0, 2.0 * np.pi, n_v, endpoint=False)
    cv, sv = np.cos(v), np.sin(v)
    verts = (c[:, None, :] + tube * (cv[None, :, None] * n[:, None, :]
                                     + sv[None, :, None] * b[:, None, :]))
    verts = verts.reshape(-1, 3)

    idx = np.arange(n_u * n_v).reshape(n_u, n_v)
    i00 = idx
    i10 = np.roll(idx, -1, axis=0)
    i01 = np.roll(idx, -1, axis=1)
    i11 = np.roll(np.roll(idx, -1, axis=0), -1, axis=1)
    f1 = np.stack([i00, i10, i11], axis=-1).reshape(-1, 3)
    f2 = np.stack([i00, i11, i01], axis=-1).reshape(-1, 3)
    faces = np.concatenate([f1, f2], axis=0)
    # orient windings outward (one-sided materials need CCW-outward): a
    # face normal must point away from the tube's center-curve point
    centers = np.repeat(c, n_v, axis=0)
    fv = verts[faces]
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    out_dir = fv.mean(1) - centers[faces[:, 0]]
    flip = np.einsum("fd,fd->f", fn, out_dir) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return verts, faces


def write_obj(path, verts, faces):
    with open(path, "w") as fh:
        fh.write("# procedural torus-knot stand-in mesh\n")
        np.savetxt(fh, verts, fmt="v %.6f %.6f %.6f")
        np.savetxt(fh, faces + 1, fmt="f %d %d %d")


def ensure(name, n_u, n_v):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = os.path.join(here, "scenes", "meshes", "procedural")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, name)
    if not os.path.exists(path):
        verts, faces = torus_knot(n_u, n_v)
        write_obj(path, verts, faces)
        print(f"wrote {path}: {faces.shape[0]} tris")
    return path


def ensure_at(relpath, n_u, n_v, **kw):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(here, "scenes", "meshes", relpath)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not os.path.exists(path):
        verts, faces = torus_knot(n_u, n_v, **kw)
        write_obj(path, verts, faces)
        print(f"wrote {path}: {faces.shape[0]} tris")
    return path


def ensure_texture(relpath, size=256):
    """Deterministic marble-ish RGB texture for scenes that reference
    unshipped texture assets."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(here, "scenes", "meshes", relpath)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not os.path.exists(path):
        y, x = np.mgrid[0:size, 0:size] / size
        v = 0.5 + 0.5 * np.sin(8 * np.pi * x + 4 * np.sin(2 * np.pi * y))
        img = np.stack([0.4 + 0.5 * v, 0.5 + 0.3 * v, 0.8 - 0.3 * v], -1)
        from PIL import Image
        Image.fromarray((img * 255).astype(np.uint8)).save(path)
        print(f"wrote {path}")
    return path


def ensure_all():
    ENSURE["knot2k"]()                  # 2,000 tris (BVH-walk tests)
    ensure("knot90k.obj", 900, 50)      # 90,000 tris
    ENSURE["knot290k"]()                # 290,000 tris
    # stand-ins for reference scene assets the reference repo does not
    # ship (external downloads): geometry differs (torus knots), but the
    # scenes become runnable end-to-end
    ensure_at("bvh-benchmark/bunny.obj", 900, 50)
    ensure_at("bvh-benchmark/bunny-full.obj", 1200, 120)   # 288k tris
    ensure_at("cornell/bunny_body.obj", 300, 24, R=0.3, r=0.12, tube=0.06)
    ensure_at("cornell/bunny_head.obj", 120, 12, R=0.15, r=0.06,
              tube=0.035)
    ensure_at("cornell/bunny_full1.obj", 400, 30, R=0.35, r=0.12,
              tube=0.06)
    ensure_at("cornell/bunny_full2.obj", 400, 30, R=0.35, r=0.12,
              tube=0.06)
    ensure_texture("textures/crystal.jpg")
    ensure_texture("textures/lava.jpeg")
    ensure_texture("textures/mat.jpeg")
    ensure_texture("kitchen_textures/wood.jpg")
    ensure_texture("../complex/bathroom/textures/wood.jpg")
    ENSURE["tornado"]()
    ensure_vol("janga-smoke-264-136-136.vol", kind="plume")
    ensure_orbs()
    ensure_foam()
    ensure_vn_balls()
    # generic room-layout stand-ins for the remaining unshipped asset
    # packs (the reference repo doesn't ship them either): geometry is
    # procedural, but every material/emitter/texture binding in the XML is
    # exercised and the scenes render end-to-end
    ensure_scene_standins("cbox", "venus.xml")
    ensure_scene_standins("cbox", "vader.xml")
    ensure_scene_standins("cbox", "kitchen.xml")
    ensure_scene_standins("cbox", "skeleton.xml")
    ensure_scene_standins("cbox", "smaller.xml")
    ensure_scene_standins("csphere", "whiskey.xml")
    ensure_scene_standins("cbox", "bathroom.xml")
    ensure_texture("textures/bump/bump1.jpg")
    ensure_texture("textures/bump/bump2.jpg")


def _quad(path, p0, p1, p2, p3):
    """Two-triangle quad with winding p0->p1->p2 (CCW from the normal
    side)."""
    with open(path, "w") as fh:
        fh.write("# procedural quad stand-in\n")
        for v in (p0, p1, p2, p3):
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        fh.write("f 1 2 3\nf 1 3 4\n")


def ensure_scene_standins(suite, name):
    """Generate missing meshes for one scene as a plausible room layout.

    Reads the scene XML directly: camera lookat fixes the room frame;
    floor/ceiling/wall-named meshes become the room shell, emitter-bound
    meshes become downward ceiling panels, everything else lands on the
    floor in a deterministic ring in front of the camera."""
    import xml.etree.ElementTree as ET
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    xml_path = os.path.join(here, "scenes", suite, name)
    if not os.path.exists(xml_path):
        return
    root = ET.parse(xml_path).getroot()

    origin = target = None
    for la in root.iter("lookat"):
        origin = np.float32([float(x) for x in
                             la.get("origin").replace(",", " ").split()])
        target = np.float32([float(x) for x in
                             la.get("target").replace(",", " ").split()])
        break
    if origin is None:
        return
    d = float(np.linalg.norm(target - origin)) or 1.0
    fwd = (target - origin) / d
    c = origin + fwd * (2.0 * d)               # room center ahead of cam
    half = 3.0 * d
    y_lo = min(origin[1], target[1]) - 0.8 * d
    y_hi = max(origin[1], target[1]) + 1.6 * d

    shapes = []
    for sh in root.iter("shape"):
        fn = None
        has_emitter = False
        for s in sh.iter("string"):
            if s.get("name") == "filename":
                fn = s.get("value")
        for r in sh.iter("ref"):
            if r.get("type") == "emitter":
                has_emitter = True
        if fn:
            shapes.append((fn, has_emitter))

    obj_i = emit_i = 0
    for fn, has_emitter in shapes:
        path = os.path.normpath(os.path.join(here, "scenes", suite, fn))
        if os.path.exists(path):
            continue
        os.makedirs(os.path.dirname(path), exist_ok=True)
        base = os.path.basename(fn).lower()
        cx, cy, cz = float(c[0]), 0.0, float(c[2])
        if has_emitter or any(k in base for k in
                              ("emitter", "light", "lamp", "bulb")):
            # small ceiling panel facing down, offset per emitter index
            s = 0.25 * d
            ox = cx + (emit_i % 3 - 1) * d
            oz = cz + (emit_i // 3 - 0.5) * d
            y = y_hi - 0.05 * d
            _quad(path, (ox - s, y, oz - s), (ox + s, y, oz - s),
                  (ox + s, y, oz + s), (ox - s, y, oz + s))
            emit_i += 1
        elif any(k in base for k in ("floor", "bottom", "ground")):
            _quad(path, (cx - half, y_lo, cz + half),
                  (cx + half, y_lo, cz + half),
                  (cx + half, y_lo, cz - half),
                  (cx - half, y_lo, cz - half))
        elif any(k in base for k in ("ceiling", "top")):
            _quad(path, (cx - half, y_hi, cz - half),
                  (cx + half, y_hi, cz - half),
                  (cx + half, y_hi, cz + half),
                  (cx - half, y_hi, cz + half))
        elif any(k in base for k in ("wall", "back", "door", "window",
                                     "frame", "closet", "drawings")):
            # side walls, assigned by a STABLE hash (Python's hash() is
            # salted per process: regenerated meshes would land on
            # different sides than the committed sweep goldens)
            import zlib
            side = zlib.crc32(base.encode()) & 3
            lo, hi = y_lo, y_hi
            if side == 0:     # +x
                _quad(path, (cx + half, lo, cz - half),
                      (cx + half, lo, cz + half),
                      (cx + half, hi, cz + half), (cx + half, hi, cz - half))
            elif side == 1:   # -x
                _quad(path, (cx - half, lo, cz + half),
                      (cx - half, lo, cz - half),
                      (cx - half, hi, cz - half), (cx - half, hi, cz + half))
            elif side == 2:   # +z
                _quad(path, (cx + half, lo, cz + half),
                      (cx - half, lo, cz + half),
                      (cx - half, hi, cz + half), (cx + half, hi, cz + half))
            else:             # -z
                _quad(path, (cx - half, lo, cz - half),
                      (cx + half, lo, cz - half),
                      (cx + half, hi, cz - half), (cx - half, hi, cz - half))
        else:
            # object on the floor: deterministic ring position in view
            ang = 2.399963 * obj_i           # golden angle
            r = (0.5 + 0.35 * (obj_i % 4)) * d
            ox = cx + r * np.cos(ang)
            oz = cz + r * np.sin(ang)
            size = (0.18 + 0.06 * (obj_i % 3)) * d
            verts, faces = torus_knot(120, 12, R=1.0, r=0.35, tube=0.18)
            verts = verts * size * 0.5
            verts[:, 1] -= verts[:, 1].min() - float(y_lo)
            verts[:, 0] += ox
            verts[:, 2] += oz
            write_obj(path, verts, faces)
            obj_i += 1
        print(f"wrote {path}")


def _uv_sphere(center, radius, n_u=24, n_v=16):
    """UV sphere; returns (verts, faces, vertex_normals)."""
    cs = np.asarray(center, float)
    us = np.linspace(0.0, 2 * np.pi, n_u, endpoint=False)
    vs = np.linspace(0.0, np.pi, n_v + 1)[1:-1]      # exclude poles
    ring = np.stack([np.outer(np.sin(vs), np.cos(us)),
                     np.cos(vs)[:, None] * np.ones_like(us)[None, :],
                     np.outer(np.sin(vs), np.sin(us))], axis=-1)
    ring = ring.reshape(-1, 3)
    top = np.array([[0.0, 1.0, 0.0]])
    bot = np.array([[0.0, -1.0, 0.0]])
    normals = np.concatenate([top, ring, bot])
    verts = cs + radius * normals
    n_rings = len(vs)
    it, ib = 0, 1 + len(ring)

    def rid(r, u):
        return 1 + r * n_u + (u % n_u)

    faces = []
    for u in range(n_u):                             # caps
        faces.append((it, rid(0, u + 1), rid(0, u)))
        faces.append((ib, rid(n_rings - 1, u), rid(n_rings - 1, u + 1)))
    for r in range(n_rings - 1):
        for u in range(n_u):
            a, b = rid(r, u), rid(r, u + 1)
            c, d = rid(r + 1, u), rid(r + 1, u + 1)
            faces.append((a, b, d))
            faces.append((a, d, c))
    faces = np.asarray(faces)
    # orient windings outward (one-sided materials need CCW-outward)
    fv = verts[faces]
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    out_dir = fv.mean(1) - cs
    flip = np.einsum("fd,fd->f", fn, out_dir) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return verts, faces, normals


def ensure_vn_balls():
    """flat-ball / smooth-ball stand-ins for cbox-vn.xml: the same sphere
    mesh without and WITH per-vertex normals (f v//vn) — the scene that
    exercises barycentric shading-normal interpolation."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = os.path.join(here, "scenes", "meshes", "cornell")
    for name, center, radius, smooth in (
            ("flat-ball.obj", (1.6, 1.0, 1.4), 1.0, False),
            ("smooth-ball.obj", (3.8, 1.0, 3.2), 1.0, True)):
        path = os.path.join(d, name)
        if os.path.exists(path):
            continue
        verts, faces, normals = _uv_sphere(center, radius)
        with open(path, "w") as fh:
            fh.write("# procedural UV-sphere stand-in\n")
            np.savetxt(fh, verts, fmt="v %.6f %.6f %.6f")
            if smooth:
                np.savetxt(fh, normals, fmt="vn %.6f %.6f %.6f")
                np.savetxt(fh, np.repeat(faces + 1, 2, axis=1),
                           fmt="f %d//%d %d//%d %d//%d")
            else:
                np.savetxt(fh, faces + 1, fmt="f %d %d %d")
        print(f"wrote {path}: {faces.shape[0]} tris"
              f" ({'smooth' if smooth else 'flat'})")


def _box_mesh(lo, hi):
    """Closed axis-aligned box; 12 tris, CCW-outward winding."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                        [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                        [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]])
    quads = [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
             (2, 3, 7, 6), (1, 2, 6, 5), (3, 0, 4, 7)]
    faces = []
    for a, b, c, d in quads:
        faces += [(a, b, c), (a, c, d)]
    return corners, np.asarray(faces)


def ensure_foam():
    """Stand-in for the transient foam slab (reference trans/foam.xml:
    ../meshes/foam/foam4.obj, unshipped). A 4 mm-thick closed slab of
    scattering medium (u_s=313.66 -> optical depth ~1.25) centered between
    the collimated laser (z=+0.02) and camera (z=-0.02), wide enough to
    cover the 15-degree-fov center crop."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(here, "scenes", "meshes", "foam", "foam4.obj")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not os.path.exists(path):
        verts, faces = _box_mesh([-0.06, -0.06, -0.002],
                                 [0.06, 0.06, 0.002])
        write_obj(path, verts, faces)
        print(f"wrote {path}: {faces.shape[0]} tris")
    return path


def ensure_orbs():
    """Stand-ins for the ite-orb material-orb scene (reference README.md:34:
    ~500k prims, 24 bounces). The original orb meshes bake world positions,
    so the knots are translated to a plausible two-row layout around the
    scene's camera target; six ~80k-tri orbs total ~480k prims."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = os.path.join(here, "scenes", "meshes", "ite-orb")
    os.makedirs(d, exist_ok=True)
    orbs = {"left.obj": (-0.95, -0.55), "mid.obj": (-0.35, -0.5),
            "right.obj": (0.25, -0.55), "back-left.obj": (-0.8, 0.25),
            "back-mid.obj": (-0.2, 0.3), "back-right.obj": (0.4, 0.25)}
    for name, (cx, cz) in orbs.items():
        path = os.path.join(d, name)
        if os.path.exists(path):
            continue
        verts, faces = torus_knot(400, 100, R=1.0, r=0.35, tube=0.18)
        verts = verts * 0.13 + np.array([cx, 0.2, cz])
        write_obj(path, verts, faces)
        print(f"wrote {path}: {faces.shape[0]} tris")
    fl = os.path.join(d, "floor.obj")
    if not os.path.exists(fl):
        with open(fl, "w") as fh:
            fh.write("v -6 0 -6\nv 6 0 -6\nv 6 0 6\nv -6 0 6\n"
                     "f 1 3 2\nf 1 4 3\n")
        print(f"wrote {fl}")
    em = os.path.join(d, "emitter.obj")
    if not os.path.exists(em):
        with open(em, "w") as fh:
            fh.write("v -0.65 2.2 -1.15\nv -0.05 2.2 -1.15\n"
                     "v -0.05 2.2 -0.55\nv -0.65 2.2 -0.55\n"
                     "f 1 2 3\nf 1 3 4\n")
        print(f"wrote {em}")


def ensure_vol(name, kind="plume", n=96):
    """Deterministic procedural density grid for scenes that reference
    unshipped EmberGen `.vol` assets (mitsuba3 format via write_vol)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(here, "scenes", "volume", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        return path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from adapt_tpu.native import write_vol
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / (n - 1)
    swirl = np.sin(7.0 * y + 11.0 * (x + z)) * 0.04
    if kind == "tornado":
        # swirling funnel: radius grows with height around a wavy axis
        cx = 0.5 + 0.08 * np.sin(6.0 * y) + swirl
        cz = 0.5 + 0.08 * np.cos(6.0 * y) + swirl
        r = np.sqrt((x - cx) ** 2 + (z - cz) ** 2)
        funnel = 0.06 + 0.25 * y
        d = np.exp(-((r / funnel) ** 2) * 4.0) * (0.3 + 0.7 * y)
    else:
        # buoyant plume: dense core rising and spreading
        cx = 0.5 + 0.1 * np.sin(4.0 * y) + swirl
        cz = 0.5 + 0.1 * np.cos(5.0 * y) + swirl
        r = np.sqrt((x - cx) ** 2 + (z - cz) ** 2)
        width = 0.12 + 0.18 * y * y
        d = np.exp(-((r / width) ** 2) * 3.0) * np.exp(-2.5 * y)
    d *= (0.75 + 0.25 * np.sin(13.0 * x) * np.sin(17.0 * z)
          * np.sin(9.0 * y))
    write_vol(path, d.astype(np.float32))
    print(f"wrote {path}")
    return path


# assets the tests and chip_smoke.py need, by name
TORNADO_VOL = "embergen_dust_devil_tornado_a_50-256-256-256.vol"
ENSURE = {
    "knot2k": lambda: ensure("knot2k.obj", 100, 10),
    "knot290k": lambda: ensure("knot290k.obj", 1450, 100),
    "tornado": lambda: ensure_vol(TORNADO_VOL, kind="tornado"),
}


if __name__ == "__main__":
    names = sys.argv[1:]
    if names:
        for n in names:
            ENSURE[n]()
    else:
        ensure_all()
