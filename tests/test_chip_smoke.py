"""chip_smoke.py: the parts that run without a card (exit codes, the
result line, the compile-cache location, its checks at toy sizes on the
CPU), plus its card-only checks under the `gpu` marker."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from conftest import SCENE_DIR

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from adapt_tpu.ops import intersect_pallas  # noqa: E402
from adapt_tpu.utils import runtime  # noqa: E402


def _fake_smi(tmp_path):
    """A PATH dir whose nvidia-smi names a card, so the run gets as far as
    asking JAX for the CUDA device."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    smi = bindir / "nvidia-smi"
    smi.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W'\n")
    smi.chmod(0o755)
    return str(bindir)


@pytest.mark.parametrize("smi", ["absent", "present"])
@pytest.mark.parametrize("layout", ["checkout", "script_alone"])
def test_no_card_exits_nonzero_without_result(tmp_path, smi, layout):
    """Without a CUDA card (or without the rest of the repo) the script
    fails, and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    if smi == "present":
        env["PATH"] = _fake_smi(tmp_path) + os.pathsep + env["PATH"]
    else:
        env["PATH"] = os.pathsep.join(
            p for p in env["PATH"].split(os.pathsep)
            if not os.path.exists(os.path.join(p, "nvidia-smi")))
    script = os.path.join(REPO, "chip_smoke.py")
    if layout == "script_alone":
        alone = tmp_path / "alone"
        alone.mkdir()
        script = str(alone / "chip_smoke.py")
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
    p = subprocess.run([sys.executable, script], env=env,
                       capture_output=True, text=True, timeout=240,
                       cwd=str(tmp_path))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_result_line_is_the_contract():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()])
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(chip_smoke.result_line([Dev()] * 4)) == {
        "ok": True, "device": {"platform": "gpu",
                               "kind": "NVIDIA H100 80GB HBM3",
                               "count": 4}}


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    assert runtime.compile_cache_dir() == want
    assert runtime.setup_compile_cache() == want
    if env_set:   # JAX reads the variable itself; nothing is set in code
        assert jax.config.jax_compilation_cache_dir == before
    else:
        assert jax.config.jax_compilation_cache_dir == want


def test_cli_caches_under_env_dir(tmp_path):
    """render.py keeps its compiled programs in $JAX_COMPILATION_CACHE_DIR."""
    cache = tmp_path / "cache"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="",
               JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "render.py"), "--arch", "cpu",
         "--input_path", SCENE_DIR, "--output_path", str(tmp_path / "out"),
         "--width", "16", "--height", "16", "--max_bounce", "2",
         "--iter_num", "1", "--no_watermark"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=240)
    assert p.returncode == 0, p.stderr[-2000:]
    assert cache.is_dir() and any(cache.iterdir())


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(intersect_pallas, "_INTERPRET", True)


def test_kernel_check_at_toy_width(interpret):
    scene, cfg = chip_smoke.load("cbox", "cbox.xml", 32)
    out = chip_smoke.kernel_check(scene, cfg, 2048)
    assert out["rays"] == 2048 and out["hits"] > 0
    assert out["closest_mismatch_share"] <= chip_smoke.MISMATCH_MAX


def test_goldens_check_on_cpu():
    out = chip_smoke.golden_check()
    assert set(out) == {"cbox_pt_48.npy", "cbox_bdpt_48.npy",
                        "vptcbox_48.npy", "cbox_ao_48.npy",
                        "cbox_direct_48.npy"}


def test_multichip_check_on_virtual_devices():
    """The four-card comparison, rehearsed on four virtual CPU devices."""
    devices = jax.devices()[:4]
    assert len(devices) == 4
    out = chip_smoke.multichip_check(devices, w=16)
    for kind in ("pt", "bdpt"):
        assert out[kind][2] <= chip_smoke.MULTICHIP_TOL[kind]


@pytest.mark.gpu
def test_goldens_on_card(gpu_device):
    with jax.default_device(gpu_device):
        chip_smoke.golden_check()
