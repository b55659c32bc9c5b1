"""adapt_tpu CLI: progressive rendering main loop (reference render.py).

Headless progressive loop with rich progress, checkpoint/resume, transient
export, profiler hooks, watermark, and image output. Renderer dispatch by
--type {pt, vpt, bdpt, ao, direct} (reference render.py:33-34).
"""
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from adapt_tpu.parsers.opts import get_options


def build_renderer(opts, scene, cfg, configs):
    import importlib
    if opts.multichip:
        import jax
        from adapt_tpu.parallel.sharding import make_mesh, MultiChipRenderer
        n = len(jax.devices()) if opts.multichip < 0 else opts.multichip
        if opts.type == "bdpt":
            kw = {"bdpt": True}
        elif opts.type == "vpt":
            from adapt_tpu.renderer.vpt import trace_vpt
            kw = {"trace_fn": trace_vpt}
        elif opts.type == "pt":
            kw = {}
        else:
            raise SystemExit(f"--multichip supports pt/vpt/bdpt, "
                             f"not {opts.type}")
        # transient BDPT scales over independent sample batches (px=1)
        spp_par = n if (opts.type == "bdpt" and cfg.transient) else None
        mesh = make_mesh(n, spp_parallel=spp_par)
        print(f"multichip mesh: {dict(mesh.shape)} over {n} devices")
        return MultiChipRenderer(scene, cfg, mesh, seed=opts.seed, **kw)
    mapping = {"pt": ("pt", "Renderer"), "vpt": ("vpt", "VolumeRenderer"),
               "bdpt": ("bdpt", "BDPT"), "ao": ("ssao", "SSAORenderer"),
               "direct": ("direct", "DirectRenderer")}
    mod_name, cls_name = mapping[opts.type]
    mod = importlib.import_module(f"adapt_tpu.renderer.{mod_name}")
    return getattr(mod, cls_name)(scene, cfg, seed=opts.seed)


def checkpoint_path(opts, cfg):
    """Renderer type AND resolution go in the filename so --width/--height
    overrides of the same scene get distinct checkpoints (the load-time
    consistency check in renderer/base.py would reject a collision, but a
    colliding save would still clobber the other run's file)."""
    os.makedirs("./checkpoint", exist_ok=True)
    return (f"./checkpoint/{opts.img_name}-{opts.scene}-{opts.type}"
            f"-{cfg.w}x{cfg.h}.pkl")


def save_check_point(rdr, opts):
    with open(checkpoint_path(opts, rdr.cfg), "wb") as f:
        pickle.dump(rdr.get_check_point(), f)


def export_transient_profile(rdr, opts, configs):
    """Export one image per time bin (reference render.py:36-58)."""
    from adapt_tpu.utils.imaging import (quantile_normalize, write_image,
                                         apply_watermark)
    frames = rdr.transient_frames()          # (T, h, w, 3)
    qnt = opts.normalize if opts.normalize > 0 else 0.99
    frames = frames / max(np.quantile(frames, qnt), 1e-6)
    out_dir = os.path.join(opts.output_path,
                           f"{opts.scene}-transient")
    os.makedirs(out_dir, exist_ok=True)
    for i, frame in enumerate(frames):
        if not opts.no_watermark:
            frame = apply_watermark(frame)
        write_image(os.path.join(out_dir, f"{i:04d}.{opts.img_ext}"), frame)
    np.save(os.path.join(out_dir, "frames.npy"), frames)
    print(f"transient profile: {len(frames)} frames -> {out_dir}")
    if opts.analyze:
        from adapt_tpu.utils.tdom_analyze import analyze_frames
        analyze_frames(frames, out_dir,
                       interval=float(configs.get("interval", 1.0)),
                       start_time=float(configs.get("min_time", 0.0)),
                       viz=True)


def main(argv=None):
    opts = get_options(argv)
    t_start = time.time()

    import jax
    from adapt_tpu.utils.runtime import pin_platform, setup_compile_cache
    pin_platform(opts.arch)
    if not opts.no_cache:
        setup_compile_cache()
    if opts.debug:
        jax.config.update("jax_debug_nans", True)

    from adapt_tpu.scene.compile import load_scene
    from adapt_tpu.utils.imaging import (apply_watermark, quantile_normalize,
                                         write_image)

    scene, cfg, configs = load_scene(
        os.path.join(opts.input_path, opts.scene), opts.name)
    if opts.width > 0 or opts.height > 0 or opts.max_bounce > 0:
        import dataclasses
        w = opts.width or cfg.w
        h = opts.height or cfg.h
        cfg = dataclasses.replace(
            cfg, w=w, h=h, focal=cfg.focal * min(w, h) / min(cfg.w, cfg.h),
            start_x=0, end_x=w, start_y=0, end_y=h,
            max_bounce=opts.max_bounce or cfg.max_bounce)
    if getattr(opts, "true_unwarped", False):
        import dataclasses
        if not cfg.transient:
            raise SystemExit("--true_unwarped needs a transient scene "
                             "(decomposition key in the XML)")
        cfg = dataclasses.replace(cfg, unwarp=True)
    rdr = build_renderer(opts, scene, cfg, configs)
    print(f"scene '{opts.scene}/{opts.name}' loaded: "
          f"{int(scene.prim_ng.shape[0])} prims, {cfg.w}x{cfg.h}, "
          f"renderer={opts.type}, backend={jax.default_backend()}")

    preview = None
    if opts.serve >= 0:
        from adapt_tpu.utils.preview import PreviewServer
        preview = PreviewServer(port=opts.serve,
                                name=f"{opts.scene}/{opts.name}")
        print(f"live preview: http://localhost:{preview.port}/")

    if opts.load and os.path.exists(checkpoint_path(opts, cfg)):
        with open(checkpoint_path(opts, cfg), "rb") as f:
            rdr.load_check_point(pickle.load(f))
        print(f"resumed from checkpoint at {rdr.cnt} iterations")

    iter_num = opts.iter_num if opts.iter_num > 0 \
        else configs.get("sample_count", 64)

    if opts.profile:
        jax.profiler.start_trace("./profiler_trace")

    try:
        from rich.progress import (Progress, TextColumn, BarColumn,
                                   MofNCompleteColumn, TimeElapsedColumn,
                                   TimeRemainingColumn)
        from adapt_tpu.utils.rich_utils import ItersPerSecColumn
        progress = Progress(TextColumn("[bold blue]render"), BarColumn(),
                            MofNCompleteColumn(), ItersPerSecColumn(),
                            TimeElapsedColumn(), TimeRemainingColumn())
    except ImportError:
        progress = None

    def loop_body(i):
        if opts.batch_spp > 1:
            rdr.render_batch(opts.batch_spp)
        else:
            rdr.render()
        if opts.save_iter > 0 and (i + 1) % opts.save_iter == 0:
            save_check_point(rdr, opts)
        if opts.output_freq > 0 and (i + 1) % opts.output_freq == 0:
            img = rdr.image()
            write_image(os.path.join(opts.output_path,
                                     f"{opts.img_name}_{i + 1:05d}.png"), img)
        if preview is not None and preview.due():
            preview.update(rdr.image(), rdr.cnt)

    try:
        if progress is not None:
            with progress:
                task = progress.add_task("render", total=iter_num)
                for i in range(iter_num):
                    loop_body(i)
                    progress.advance(task)
        else:
            for i in range(iter_num):
                loop_body(i)
    except KeyboardInterrupt:
        print("interrupted; saving checkpoint")
        save_check_point(rdr, opts)
        raise SystemExit(1)

    if opts.profile:
        jax.profiler.stop_trace()
        print("profiler trace written to ./profiler_trace")
    if preview is not None:
        preview.update(rdr.image(), rdr.cnt, min_interval=0.0)

    save_check_point(rdr, opts)
    img = rdr.image()
    if opts.normalize > 0:
        img = quantile_normalize(img, opts.normalize)
    if not opts.no_watermark:
        img = apply_watermark(img)
    if not opts.no_save_fig:
        out = os.path.join(opts.output_path,
                           f"{opts.img_name}.{opts.img_ext}")
        write_image(out, img)
        print(f"image written to {out}")

    if getattr(rdr, "is_transient", False):
        export_transient_profile(rdr, opts, configs)

    spp = getattr(rdr, "cnt", iter_num)
    dt = time.time() - t_start
    print(f"done: {spp} spp in {dt:.2f}s ({spp / max(dt, 1e-9):.2f} it/s)")

    if preview is not None:
        # The reference GUI window outlives the render loop (render.py:
        # 129-152): the image stays on screen until the user closes it.
        # Same contract here: keep serving the final frame until
        # SIGTERM/Ctrl-C — also removes the client-side race where the
        # server died between a poll and the fetch.
        # Scripted/CI runs: ADAPT_SERVE_AFTER=0 exits immediately, a
        # numeric value serves for that many seconds then exits.
        hold = os.environ.get("ADAPT_SERVE_AFTER", "")
        if hold != "0":
            import signal
            import threading
            done = threading.Event()
            signal.signal(signal.SIGTERM, lambda *_: done.set())
            timeout = float(hold) if hold else None
            print("render finished; preview still serving "
                  "(Ctrl-C to exit)", flush=True)
            try:
                done.wait(timeout)
            except KeyboardInterrupt:
                pass
        preview.stop()


if __name__ == "__main__":
    main()
