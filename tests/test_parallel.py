"""Multi-chip sharding: mesh construction, sharded render correctness."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from adapt_tpu.scene.compile import load_scene
from adapt_tpu.parallel.sharding import make_mesh, MultiChipRenderer
from adapt_tpu.renderer.pt import render_pass_pt

from conftest import SCENE_DIR


def test_make_mesh_shapes():
    mesh = make_mesh(8)
    assert mesh.shape["spp"] * mesh.shape["px"] == 8
    mesh = make_mesh(8, spp_parallel=4)
    assert mesh.shape == {"spp": 4, "px": 2}
    with pytest.raises(ValueError):
        make_mesh(6, spp_parallel=4)


def test_multichip_matches_single_device():
    """The sharded renderer must compute the same image a single device
    would (deterministic per-key; spp axis averages independent keys)."""
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "cbox.xml")
    cfg = dataclasses.replace(cfg, w=32, h=32, focal=cfg.focal * 32 / 512,
                              end_x=32, end_y=32, max_bounce=2,
                              anti_alias=False, stratified_sampling=False,
                              use_rr=False)
    mesh = make_mesh(8, spp_parallel=1)     # 8-way pixel sharding only
    r = MultiChipRenderer(scene, cfg, mesh, seed=3)
    out = np.asarray(r.render()).reshape(-1, 3)
    assert np.isfinite(out).all() and out.max() > 0.01

    # reference: single-device pass with the same per-shard key derivation
    from adapt_tpu.renderer.pt import trace_pt
    from adapt_tpu.renderer.base import camera_rays
    key = jax.random.PRNGKey(3)
    _, sub = jax.random.split(key)
    shard_n = cfg.n_pixels // 8
    cols = []
    for px_i in range(8):
        k = jax.random.fold_in(jax.random.fold_in(sub, 0), px_i)
        k_cam, k_tr = jax.random.split(k)
        pix = px_i * shard_n + jnp.arange(shard_n, dtype=jnp.int32)
        ro, rd = camera_rays(scene, cfg, k_cam, jnp.int32(1), pix_ids=pix)
        cols.append(np.asarray(trace_pt(scene, cfg, k_tr, ro, rd)))
    ref = np.concatenate(cols, axis=0)
    assert np.abs(out - ref).max() < 1e-4


def test_multichip_vpt_and_spp_axis():
    """VPT traces through the same sharding layer; a 2x4 ('spp','px') mesh
    must average spp groups into a finite, lit image."""
    scene, cfg, _ = load_scene(SCENE_DIR + "/vpt/", "cbox.xml")
    cfg = dataclasses.replace(cfg, w=16, h=16, focal=cfg.focal * 16 / 512,
                              end_x=16, end_y=16, max_bounce=2,
                              anti_alias=False, stratified_sampling=False,
                              use_rr=False)
    from adapt_tpu.renderer.vpt import trace_vpt
    mesh = make_mesh(8, spp_parallel=2)      # 2 spp groups x 4 px shards
    r = MultiChipRenderer(scene, cfg, mesh, trace_fn=trace_vpt, seed=1)
    r.render()
    out = np.asarray(r.render()).reshape(-1, 3)
    assert np.isfinite(out).all() and out.max() > 0.01
    assert r.cnt == 4                        # 2 renders x spp axis of 2


def test_multichip_bdpt_splat_psum():
    """BDPT over the mesh: pixel-sharded subpaths with the t=1 splat plane
    psum'd across the px axis must equal the same per-shard passes summed
    by hand on one device (exact; validates the cross-shard splat
    collective)."""
    from adapt_tpu.renderer.bdpt import bdpt_pass_core
    scene, cfg, _ = load_scene(SCENE_DIR + "/csphere/", "single-ball.xml")
    cfg = dataclasses.replace(cfg, w=16, h=16, focal=cfg.focal * 16 / 512,
                              end_x=16, end_y=16, max_bounce=3,
                              anti_alias=False, stratified_sampling=False,
                              use_rr=False, world_scattering=False,
                              medium_kinds=(), has_null_bsdf=False)
    mesh = make_mesh(4, spp_parallel=1)      # 4-way pixel sharding
    r = MultiChipRenderer(scene, cfg, mesh, seed=5, bdpt=True)
    out = np.asarray(r.render()).reshape(-1, 3)
    assert np.isfinite(out).all() and out.max() > 0.01

    key = jax.random.PRNGKey(5)
    _, sub = jax.random.split(key)
    shard_n = cfg.n_pixels // 4
    locals_, splat_sum = [], 0.0
    for px_i in range(4):
        k = jax.random.fold_in(jax.random.fold_in(sub, 0), px_i)
        pix = px_i * shard_n + jnp.arange(shard_n, dtype=jnp.int32)
        local, splat, _b, _c = bdpt_pass_core(scene, cfg, k, jnp.int32(1),
                                              pix_ids=pix)
        locals_.append(np.asarray(local))
        splat_sum = splat_sum + np.asarray(splat)
    ref = np.concatenate(locals_, axis=0) + splat_sum
    # rtol 1e-4 not 1e-5: XLA fuses the carried-interaction walk slightly
    # differently under shard_map vs single-device (FMA grouping), which
    # perturbs isolated elements by a few ulp-of-accumulation (the fused
    # dual walk measured 1 element of 768 at 3.2e-5)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)


def test_multichip_crop_matches_single_device():
    """A cropped scene must render identically on the multichip paths:
    pixels outside the crop window are zero, inside matches single-chip
    (ADVICE r1: the multichip BDPT/PT passes previously skipped
    crop_mask)."""
    from adapt_tpu.renderer.bdpt import render_pass_bdpt
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "cbox.xml")
    cfg = dataclasses.replace(cfg, w=16, h=16, focal=cfg.focal * 16 / 512,
                              start_x=4, end_x=12, start_y=2, end_y=14,
                              max_bounce=2, anti_alias=False,
                              stratified_sampling=False, use_rr=False)
    from adapt_tpu.renderer.base import crop_mask
    mask = np.asarray(crop_mask(cfg))
    assert not mask.all()

    # unidirectional
    mesh = make_mesh(4, spp_parallel=1)
    r = MultiChipRenderer(scene, cfg, mesh, seed=3)
    out = np.asarray(r.render()).reshape(-1, 3)
    assert np.isfinite(out).all()
    assert (out[~mask] == 0.0).all()
    assert out[mask].max() > 0.01

    # bdpt — crop pixels are SHARDED (not full-film-masked): the light
    # subpath count equals the traced pixel count, so the t=1 component
    # keeps single-chip (= reference) crop radiometry. Checked
    # statistically: the multichip mean inside the crop must match a
    # single-chip estimate (the old full-film-shard bug was ~2.7x here).
    rb = MultiChipRenderer(scene, cfg, mesh, seed=5, bdpt=True)
    passes = 24
    for _ in range(passes):
        rb.render()
    outb = np.asarray(rb.color).reshape(-1, 3) / rb.cnt
    assert np.isfinite(outb).all()
    assert (outb[~mask] == 0.0).all()
    assert outb[mask].max() > 0.01

    from adapt_tpu.renderer.bdpt import BDPT
    rs = BDPT(scene, cfg, seed=7)
    for _ in range(passes):
        rs.render()
    ref_m = np.asarray(rs.color).reshape(-1, 3)[mask].mean() / rs.cnt
    got_m = outb[mask].mean()
    assert abs(got_m / ref_m - 1.0) < 0.25, (got_m, ref_m)


def test_bvh_tier_dead_lane_forced_miss():
    """All three dispatch tiers honor the alive contract: dead lanes return
    a forced miss / un-occluded (ADVICE r1: the cursor-BVH tier skipped the
    masking). Needs a scene big enough that the BVH is actually built
    (P >= 64) — forcing the tier on a placeholder pack is itself covered
    by the inverted-skip placeholder (compile.py)."""
    import dataclasses as dc
    import os
    from adapt_tpu.ops.intersect import ray_intersect, does_intersect
    if not os.path.exists(SCENE_DIR
                          + "/meshes/procedural/knot2k.obj"):
        pytest.skip("procedural stand-ins not generated")
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "knot2k-test.xml")
    cfg_bvh = dc.replace(cfg, use_bvh=True, use_pallas=False)
    key = jax.random.PRNGKey(0)
    n = 64
    ro = jnp.broadcast_to(scene.cam_t, (n, 3))
    rd = jax.random.normal(key, (n, 3))
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    alive = jnp.arange(n) % 2 == 0
    it = ray_intersect(scene, cfg_bvh, ro, rd, alive=alive)
    dead = np.asarray(~alive)
    assert (np.asarray(it.obj_id)[dead] == -1).all()
    occ = np.asarray(does_intersect(scene, cfg_bvh, ro, rd, alive=alive))
    assert not occ[dead].any()
    # live lanes still intersect the box interior
    assert (np.asarray(it.obj_id)[~dead] >= 0).any()


def test_multichip_transient_bdpt_matches_sum_of_passes():
    """Transient BDPT over the spp axis: the psum'd time-bin histograms
    equal the sum of the per-device single-chip passes (same folded
    keys), and the color is their mean."""
    from adapt_tpu.renderer.bdpt import render_pass_bdpt
    scene, cfg, _ = load_scene(SCENE_DIR + "/trans/", "cbox-point.xml")
    cfg = dataclasses.replace(cfg, w=16, h=16, focal=cfg.focal * 16 / 512,
                              start_x=4, end_x=12, start_y=4, end_y=12,
                              max_bounce=3, anti_alias=False,
                              stratified_sampling=False, use_rr=False)
    assert cfg.transient
    mesh = make_mesh(4, spp_parallel=4)
    r = MultiChipRenderer(scene, cfg, mesh, seed=11, bdpt=True)
    key0 = r.key
    r.render()
    got_bins = np.asarray(r.time_bins)
    got_cnts = np.asarray(r.time_cnts)
    got_color = np.asarray(r.color) / r.cnt

    sub = jax.random.split(key0)[1]
    exp_bins = exp_cnts = exp_color = 0
    for i in range(4):
        k = jax.random.fold_in(sub, i)
        color, bins, cnts = render_pass_bdpt(scene, cfg, k,
                                             jnp.int32(r.cnt))
        exp_bins = exp_bins + np.asarray(bins)
        exp_cnts = exp_cnts + np.asarray(cnts)
        exp_color = exp_color + np.nan_to_num(np.asarray(color)) / 4
    assert (got_cnts == exp_cnts).all()
    np.testing.assert_allclose(got_bins, exp_bins, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(got_color, exp_color, rtol=2e-5, atol=1e-7)
    assert got_bins.sum() > 0
    # px-sharded meshes are rejected for transient
    with pytest.raises(ValueError):
        MultiChipRenderer(scene, cfg, make_mesh(4, spp_parallel=1),
                          bdpt=True)


def test_multichip_grid_volume_smoke():
    """Grid-volume VPT under shard_map: the tracking compaction
    (sort + dynamic while_loop rounds) must trace per-shard without
    collectives; image finite and lit."""
    from adapt_tpu.renderer.vpt import trace_vpt
    scene, cfg, _ = load_scene(SCENE_DIR + "/cbox/", "cbox-volgrid.xml")
    cfg = dataclasses.replace(cfg, w=16, h=16, focal=cfg.focal * 16 / 512,
                              end_x=16, end_y=16, max_bounce=3,
                              anti_alias=False, stratified_sampling=False,
                              use_rr=False)
    assert cfg.volume_kind
    mesh = make_mesh(4, spp_parallel=2)
    r = MultiChipRenderer(scene, cfg, mesh, trace_fn=trace_vpt, seed=2)
    out = np.asarray(r.render()).reshape(-1, 3)
    assert np.isfinite(out).all() and out.max() > 0.001
