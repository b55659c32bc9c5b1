"""End-to-end CLI smoke tests for render.py (reference render.py:65-166).

Run the real CLI in a subprocess on the CPU backend at tiny resolution:
image written, checkpoint written, resume works, --serve responds.
"""
import os
import pickle
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _read_port(proc, marker):
    """Read proc stdout lines until `marker`, return the port, then keep
    DRAINING stdout in a daemon thread: once the reader stops, the 64 KB
    pipe buffer fills with rich progress output and the render blocks on
    a write — the r2 test_cli_serve_preview flake."""
    port = None
    for line in proc.stdout:
        if marker in line:
            port = int(line.rsplit(":", 1)[1].strip().rstrip("/"))
            break
    threading.Thread(target=lambda: [None for _ in proc.stdout],
                     daemon=True).start()
    return port


def _run(args, tmp, timeout=240):
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "render.py"),
         "--input_path", os.path.join(REPO, "scenes"),
         "--output_path", os.path.join(tmp, "out"),
         "--width", "48", "--height", "48", "--max_bounce", "3",
         "--no_watermark", "--arch", "cpu"] + args,
        cwd=tmp, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def tmpdir_mod(tmp_path_factory):
    return str(tmp_path_factory.mktemp("cli"))


def test_cli_pt_render_checkpoint_resume(tmpdir_mod):
    tmp = tmpdir_mod
    p = _run(["--scene", "cbox", "--name", "cbox.xml", "--type", "pt",
              "--iter_num", "2", "--img_name", "smoke"], tmp)
    assert p.returncode == 0, p.stderr[-2000:]
    assert os.path.exists(os.path.join(tmp, "out", "smoke.png")), p.stdout
    cks = [f for f in os.listdir(os.path.join(tmp, "checkpoint"))
           if f.endswith(".pkl")]
    assert cks
    with open(os.path.join(tmp, "checkpoint", cks[0]), "rb") as f:
        ck = pickle.load(f)
    assert int(np.asarray(ck["counter"])) == 2

    # resume two more iterations from the checkpoint
    p = _run(["--scene", "cbox", "--name", "cbox.xml", "--type", "pt",
              "--iter_num", "2", "--img_name", "smoke", "-l"], tmp)
    assert p.returncode == 0, p.stderr[-2000:]
    with open(os.path.join(tmp, "checkpoint", cks[0]), "rb") as f:
        ck = pickle.load(f)
    assert int(np.asarray(ck["counter"])) == 4


def test_cli_multichip(tmpdir_mod):
    """--multichip renders over a virtual 8-device ('spp','px') mesh."""
    tmp = tmpdir_mod
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "render.py"),
         "--input_path", os.path.join(REPO, "scenes"),
         "--output_path", os.path.join(tmp, "out"),
         "--scene", "cbox", "--name", "cbox.xml", "--type", "pt",
         "--arch", "cpu", "--multichip", "-1",
         "--width", "48", "--height", "48", "--max_bounce", "3",
         "--iter_num", "2", "--img_name", "mc", "--no_watermark"],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "multichip mesh" in p.stdout, p.stdout
    assert os.path.exists(os.path.join(tmp, "out", "mc.png"))


def test_cli_transient_analyze(tmpdir_mod):
    """Transient BDPT through the CLI: per-bin frame export + time-domain
    analysis artifacts (reference render.py:36-58 + utils/tdom_analyze)."""
    tmp = tmpdir_mod
    p = _run(["--scene", "trans", "--name", "cbox-point.xml",
              "--type", "bdpt", "--iter_num", "2", "--img_name", "tr",
              "--analyze"], tmp, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    tdir = os.path.join(tmp, "out", "trans-transient")
    assert os.path.exists(os.path.join(tdir, "frames.npy"))
    pngs = [f for f in os.listdir(tdir) if f.endswith(".png")]
    assert len(pngs) >= 8, pngs
    assert "peak" in p.stdout.lower() or any(
        f.endswith((".data", ".txt", ".json")) or "curve" in f
        for f in os.listdir(tdir)), (p.stdout[-500:], os.listdir(tdir))


def test_scene_viz_flythrough(tmpdir_mod):
    """scene_viz --serve: keyboard commands over HTTP move the camera,
    return the live <lookat> line, and refresh the frame."""
    import json
    tmp = tmpdir_mod
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONUNBUFFERED"] = "1"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scene_viz.py"),
         "--input_path", os.path.join(REPO, "scenes"),
         "--scene", "cbox", "--name", "cbox.xml", "--res", "64",
         "--serve", "0", "--arch", "cpu"],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        port = _read_port(proc, "flythrough: http")
        assert port, "no URL printed"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/key?k=w", timeout=120) as rsp:
            j = json.loads(rsp.read())
        assert "<lookat" in j["lookat"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/key?k=L", timeout=120) as rsp:
            j2 = json.loads(rsp.read())
        assert j2["version"] > j["version"]
        assert j2["lookat"] != j["lookat"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/frame.png", timeout=60) as rsp:
            png = rsp.read()
        assert png[:4] == b"\x89PNG"
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_cli_serve_preview(tmpdir_mod):
    """--serve must expose the incremental preview over HTTP."""
    tmp = tmpdir_mod
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONUNBUFFERED"] = "1"   # the preview-URL line must not sit in
    proc = subprocess.Popen(        # a block buffer until process exit
        [sys.executable, os.path.join(REPO, "render.py"),
         "--input_path", os.path.join(REPO, "scenes"),
         "--output_path", os.path.join(tmp, "out"),
         "--scene", "cbox", "--name", "cbox.xml", "--type", "pt",
         "--width", "48", "--height", "48", "--max_bounce", "3",
         "--iter_num", "60", "--output_freq", "5",
         "--serve", "0", "--no_watermark", "--arch", "cpu"],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        port = _read_port(proc, "live preview: http")
        assert port, "no preview URL printed"
        # poll until a preview PNG is served (first render pass compiles;
        # the server 503s until the first frame is published)
        import time
        png, last_err = None, None
        for _ in range(180):
            if proc.poll() is not None:
                break       # render finished — server gone; fail below
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/frame.png",
                        timeout=2) as r:
                    png = r.read()
                if png[:4] == b"\x89PNG":
                    break
            except Exception as e:
                last_err = e
            time.sleep(1)
        assert png and png[:4] == b"\x89PNG", (png, last_err, proc.poll())
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_config_file_boolean_flags(tmp_path):
    """Config files accept configargparse-style 'flag = true/false' lines
    for store_true flags (the naive '--debug true' expansion crashed
    argparse)."""
    from adapt_tpu.parsers.opts import get_options
    cfgf = tmp_path / "r.conf"
    cfgf.write_text("debug = true\nno_watermark = false\n"
                    "iter_num = 7\nscene = vpt\n")
    opts = get_options(["--config", str(cfgf)])
    assert opts.debug is True
    assert opts.no_watermark is False
    assert opts.iter_num == 7 and opts.scene == "vpt"
    # CLI still overrides the file
    opts = get_options(["--config", str(cfgf), "--iter_num", "9"])
    assert opts.iter_num == 9
    bad = tmp_path / "bad.conf"
    bad.write_text("debug = maybe\n")
    import pytest as _pytest
    with _pytest.raises(SystemExit):
        get_options(["--config", str(bad)])
