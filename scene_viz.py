"""Scene configurator / previewer (reference scene_viz.py, headless).

Renders a fast normal-shaded preview of a scene from the scene camera or a
CLI-overridden pose, writes the image, and prints the XML <lookat> line for
authoring.

Two substitutes for the reference's GGUI window (no display server on an
accelerator host):
  * one-shot: repeated invocations with --origin/--target;
  * interactive: `--serve PORT` opens a browser flythrough — WASD/RF move
    in the camera frame, arrow keys yaw/pitch, 1/2/3 switch
    normal/depth/direct shading, exactly the reference's keyboard controls
    (scene_viz.py:169-243) driven over HTTP; the page shows the live
    <lookat> line for pasting into the XML.

    python scene_viz.py --scene cbox --name cbox.xml \
        --origin 2.78,2.73,-8 --target 2.78,2.73,-7
    python scene_viz.py --scene cbox --name cbox.xml --serve 8044
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def parse_vec(s):
    return np.array([float(x) for x in s.split(",")], np.float32)


def main():
    ap = argparse.ArgumentParser("adapt_tpu scene preview")
    ap.add_argument("--input_path", default="./scenes/")
    ap.add_argument("--scene", default="cbox")
    ap.add_argument("--name", default="cbox.xml")
    ap.add_argument("--origin", type=str, default=None,
                    help="camera origin 'x,y,z' (default: scene camera)")
    ap.add_argument("--target", type=str, default=None,
                    help="look-at target 'x,y,z'")
    ap.add_argument("--fov", type=float, default=0.0,
                    help="override field of view (degrees)")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--mode", choices=["normal", "depth", "direct"],
                    default="normal")
    ap.add_argument("--out", default="./outputs/scene_viz.png")
    ap.add_argument("--arch", default="gpu", choices=["gpu", "cpu"],
                    help="jax platform; gpu pins CUDA and fails where "
                         "there is no card")
    ap.add_argument("--serve", type=int, default=-1, metavar="PORT",
                    help="interactive browser flythrough on PORT "
                         "(0 = pick a free port)")
    opts = ap.parse_args()

    import jax
    from adapt_tpu.utils.runtime import pin_platform, setup_compile_cache
    pin_platform(opts.arch)
    setup_compile_cache()
    import dataclasses
    import jax.numpy as jnp
    from adapt_tpu.scene.compile import load_scene
    from adapt_tpu.ops.math3d import np_rotation_between, fov2focal
    from adapt_tpu.ops.intersect import ray_intersect
    from adapt_tpu.renderer.base import camera_rays
    from adapt_tpu.utils.imaging import write_image

    scene, cfg, configs = load_scene(
        os.path.join(opts.input_path, opts.scene), opts.name)
    r = opts.res
    fov = opts.fov if opts.fov > 0 else configs["fov"]
    cfg = dataclasses.replace(cfg, w=r, h=r, focal=fov2focal(fov, r),
                              start_x=0, end_x=r, start_y=0, end_y=r,
                              anti_alias=False, stratified_sampling=False)

    if opts.origin is not None and opts.target is not None:
        origin = parse_vec(opts.origin)
        target = parse_vec(opts.target)
        direction = target - origin
        direction = direction / np.linalg.norm(direction)
        cam_r = np_rotation_between(np.float32([0, 0, 1]), direction)
        scene = dataclasses.replace(scene, cam_r=jnp.asarray(cam_r),
                                    cam_t=jnp.asarray(origin))
    else:
        origin = np.asarray(scene.cam_t)
        direction = np.asarray(scene.cam_r @ jnp.array([0., 0., 1.]))
        target = origin + direction

    def render_frame(origin, direction, mode):
        """(h, w, 3) float image of the pose; jit reuse across poses (the
        pose lives in scene.cam_r/cam_t arrays, so shapes never change)."""
        cam_r = np_rotation_between(np.float32([0, 0, 1]),
                                    direction.astype(np.float32))
        sc = dataclasses.replace(scene, cam_r=jnp.asarray(cam_r),
                                 cam_t=jnp.asarray(origin
                                                   .astype(np.float32)))
        ray_o, ray_d = camera_rays(sc, cfg, jax.random.PRNGKey(0),
                                   jnp.int32(0))
        it = ray_intersect(sc, cfg, ray_o, ray_d)
        if mode == "normal":
            img = np.asarray(jnp.where(it.is_hit[..., None],
                                       it.n_s * 0.5 + 0.5, 0.0))
        elif mode == "depth":
            t = np.asarray(jnp.where(it.is_hit, it.t, 0.0))
            img = np.repeat((t / max(t.max(), 1e-6))[:, None], 3, -1)
        else:
            from adapt_tpu.renderer.direct import render_pass_direct
            img, _d, _n = render_pass_direct(sc, cfg, jax.random.PRNGKey(0),
                                             jnp.int32(0))
            img = np.asarray(img)
        if mode == "direct":
            img = np.clip(img, 0.0, 1.0) ** (1 / 2.2)
        return np.swapaxes(img.reshape(r, r, 3), 0, 1)[::-1]

    def lookat_line(origin, direction):
        tgt = origin + direction
        return (f'<lookat target="{tgt[0]:.4g}, {tgt[1]:.4g}, '
                f'{tgt[2]:.4g}" origin="{origin[0]:.4g}, {origin[1]:.4g}, '
                f'{origin[2]:.4g}" up="0, 1, 0"/>')

    if opts.serve >= 0:
        serve(opts, render_frame, lookat_line, origin, direction)
        return

    frame = render_frame(origin, direction, opts.mode)
    write_image(opts.out, frame, gamma=1.0)
    print(f"preview written to {opts.out}")
    print("XML camera pose:")
    print("  " + lookat_line(origin, direction))


_VIZ_PAGE = b"""<!doctype html>
<html><head><title>adapt_tpu scene_viz</title>
<style>body{background:#111;color:#ddd;font-family:monospace;
text-align:center}img{image-rendering:pixelated;max-width:92vw;
max-height:80vh;border:1px solid #444}#p{color:#8c8}</style></head>
<body><h3>scene_viz - WASD/RF move, arrows look, 1/2/3 mode</h3>
<img id="v" src="/frame.png"><div id="p"></div>
<script>
let busy=false;
async function key(k){
  if(busy) return; busy=true;
  try{
    const r=await fetch('/key?k='+encodeURIComponent(k));
    const j=await r.json();
    document.getElementById('p').textContent=j.lookat;
    document.getElementById('v').src='/frame.png?'+j.version;
  }catch(e){}
  busy=false;
}
window.addEventListener('keydown',e=>{
  const m={'w':'w','a':'a','s':'s','d':'d','r':'r','f':'f',
           'ArrowLeft':'L','ArrowRight':'R','ArrowUp':'U','ArrowDown':'D',
           '1':'1','2':'2','3':'3'};
  if(m[e.key]!==undefined){e.preventDefault();key(m[e.key]);}
});
key('.');
</script></body></html>
"""


def serve(opts, render_frame, lookat_line, origin, direction):
    """Interactive flythrough over HTTP (reference scene_viz.py:169-243:
    WASD + view sliders in a GGUI window). Built on utils.preview
    PreviewServer (custom page + a /key route)."""
    import json
    import threading

    from adapt_tpu.utils.preview import PreviewServer

    state = {"o": origin.astype(np.float64),
             "d": direction / np.linalg.norm(direction),
             "mode": opts.mode, "version": 0}
    lock = threading.Lock()

    def apply_key(k):
        step = 0.25 * float(np.linalg.norm(state["o"]) + 1.0) * 0.1
        d = state["d"]
        right = np.cross(d, [0.0, 1.0, 0.0])
        rn = np.linalg.norm(right)
        right = right / rn if rn > 1e-6 else np.float64([1, 0, 0])
        if k == "w":
            state["o"] = state["o"] + d * step
        elif k == "s":
            state["o"] = state["o"] - d * step
        elif k == "a":
            state["o"] = state["o"] - right * step
        elif k == "d":
            state["o"] = state["o"] + right * step
        elif k == "r":
            state["o"] = state["o"] + np.float64([0, 1, 0]) * step
        elif k == "f":
            state["o"] = state["o"] - np.float64([0, 1, 0]) * step
        elif k in "LRUD":
            ang = np.deg2rad(5.0)
            if k in "LR":                      # yaw about +y
                sgn = ang if k == "L" else -ang
                c, sn = np.cos(sgn), np.sin(sgn)
                x, y, z = d
                d = np.float64([c * x + sn * z, y, -sn * x + c * z])
            else:                              # pitch about camera right
                sgn = ang if k == "U" else -ang
                c, sn = np.cos(sgn), np.sin(sgn)
                d = d * c + np.cross(right, d) * -sn
            state["d"] = d / np.linalg.norm(d)
        elif k in "123":
            state["mode"] = {"1": "normal", "2": "depth",
                             "3": "direct"}[k]

    def handle_key(path):
        k = path.split("k=")[-1][:1]
        with lock:
            apply_key(k)
            srv.update(render_frame(state["o"], state["d"], state["mode"]),
                       spp=0, min_interval=0.0)
            state["version"] += 1
            data = json.dumps({
                "version": state["version"],
                "lookat": lookat_line(state["o"], state["d"]),
            }).encode()
        return data, "application/json"

    srv = PreviewServer(port=opts.serve,
                        name=f"{opts.scene}/{opts.name}",
                        page=_VIZ_PAGE, routes={"/key": handle_key})
    with lock:
        srv.update(render_frame(state["o"], state["d"], state["mode"]),
                   spp=0, min_interval=0.0)
    print(f"scene_viz flythrough: http://localhost:{srv.port}/",
          flush=True)
    try:
        import time
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    srv.stop()
    print("final XML camera pose:")
    print("  " + lookat_line(state["o"], state["d"]))


if __name__ == "__main__":
    main()
