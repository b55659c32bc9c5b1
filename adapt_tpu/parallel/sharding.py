"""Multi-chip SPMD rendering over a jax.sharding.Mesh.

The reference has no distributed runtime at all (SURVEY.md §2.22: one Taichi
megakernel on one GPU). The scale-out here is SPMD over a device mesh
(on one host the cards are joined all to all by NVLink):

  * mesh axis 'px'  — the pixel wavefront is sharded across chips (each chip
    traces its own slice of the film; the scene is replicated);
  * mesh axis 'spp' — independent sample batches per chip, combined with a
    single `pmean` over the framebuffer (the only collective in the
    system).

Both axes are embarrassingly parallel, so scaling is linear; the collective
moves W*H*3 floats once per (spp-group) pass.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
try:                                    # jax >= 0.6
    from jax import shard_map
except ImportError:                     # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map


def make_mesh(n_devices: int | None = None, spp_parallel: int | None = None,
              devices=None) -> Mesh:
    """Build an ('spp', 'px') mesh over the first n_devices devices.

    spp_parallel defaults to the largest power of two <= sqrt(n)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if spp_parallel is None:
        spp_parallel = 1 << (int(math.isqrt(n_devices)).bit_length() - 1)
        while n_devices % spp_parallel:
            spp_parallel //= 2
    if n_devices % spp_parallel:
        raise ValueError(f"{n_devices=} not divisible by {spp_parallel=}")
    return Mesh(devices.reshape(spp_parallel, n_devices // spp_parallel),
                ("spp", "px"))


def render_pass_multichip(scene, cfg, mesh: Mesh, trace_fn):
    """Build a jitted multi-chip progressive pass.

    trace_fn(scene, cfg, key, ray_o, ray_d) -> (N,3) is any single-chip
    wavefront tracer (renderer/pt.py trace_pt etc.). Returns
    step(scene, key, cnt) -> (n_pixels, 3) radiance averaged over the
    mesh's spp axis and sharded over its px axis.
    """
    from ..renderer.base import camera_rays

    n_px = mesh.shape["px"]
    n_spp = mesh.shape["spp"]
    if cfg.n_pixels % n_px:
        raise ValueError(f"n_pixels={cfg.n_pixels} not divisible by "
                         f"px-axis size {n_px}")
    shard_n = cfg.n_pixels // n_px

    def _shard_fn(scene, key, cnt):
        spp_i = jax.lax.axis_index("spp")
        px_i = jax.lax.axis_index("px")
        k = jax.random.fold_in(key, spp_i)
        k = jax.random.fold_in(k, px_i)
        k_cam, k_trace = jax.random.split(k)
        pix = px_i * shard_n + jnp.arange(shard_n, dtype=jnp.int32)
        ray_o, ray_d = camera_rays(scene, cfg, k_cam, cnt, pix_ids=pix)
        color = trace_fn(scene, cfg, k_trace, ray_o, ray_d)
        # the one collective: average the spp groups' framebuffers
        return jax.lax.pmean(color, "spp")

    step = shard_map(_shard_fn, mesh=mesh,
                     in_specs=(P(), P(), P()),
                     out_specs=P("px"), **_shard_map_kw())
    return _jit_with_crop(step, cfg)


def _shard_map_kw():
    import inspect
    return ({"check_vma": False}
            if "check_vma" in inspect.signature(shard_map).parameters
            else {"check_rep": False})


def _jit_with_crop(step, cfg):
    """Jit a multichip pass, zeroing pixels outside the crop window (the
    single-chip passes do this inline; the reference only traces within
    the crop range, tracer_base.py:39-55)."""
    from ..renderer.base import crop_mask
    mask = crop_mask(cfg)
    if mask is None:
        return jax.jit(step)

    def masked(scene, key, cnt):
        return jnp.where(mask[..., None], step(scene, key, cnt), 0.0)

    return jax.jit(masked)


def render_pass_bdpt_multichip(scene, cfg, mesh: Mesh):
    """Build a jitted multi-chip BDPT pass.

    Pixel-sharded camera subpaths + per-shard light subpaths; the one
    cross-pixel interaction — t==1 light-tracing splats onto arbitrary
    film pixels (the reference's atomic +=, bdpt.py:159-162) — becomes a
    full-film splat plane per shard followed by a `psum` over the 'px'
    axis; each shard then keeps its own slice. 'spp' groups average with
    `pmean` as in the unidirectional path.

    With a crop window, ONLY crop pixels are sharded (reference
    tracer_base.py:39-55): the light-subpath count equals the traced
    pixel count exactly as on the single-chip path — tracing full-film
    shards and masking would brighten the t=1 component by
    n_pixels/crop_count (one light path is generated per traced pixel)."""
    from ..renderer.bdpt import bdpt_pass_core
    from ..renderer.base import crop_pix_ids

    n_px = mesh.shape["px"]
    pix_all = crop_pix_ids(cfg)
    n_trace = cfg.n_pixels if pix_all is None else int(pix_all.shape[0])
    if n_trace % n_px:
        raise ValueError(f"traced pixel count {n_trace} (crop window) not "
                         f"divisible by px-axis size {n_px}")
    if cfg.transient:
        raise NotImplementedError("transient BDPT is single-chip")
    shard_n = n_trace // n_px

    def _shard_fn(scene, key, cnt):
        spp_i = jax.lax.axis_index("spp")
        px_i = jax.lax.axis_index("px")
        k = jax.random.fold_in(key, spp_i)
        k = jax.random.fold_in(k, px_i)
        base = px_i * shard_n
        if pix_all is None:
            pix = base + jnp.arange(shard_n, dtype=jnp.int32)
        else:
            pix = jax.lax.dynamic_slice_in_dim(pix_all, base, shard_n)
        local, splat, _b, _c = bdpt_pass_core(scene, cfg, k, cnt,
                                              pix_ids=pix)
        splat = jax.lax.psum(splat, "px")
        mine = jnp.take(splat, pix, axis=0) if pix_all is not None \
            else jax.lax.dynamic_slice_in_dim(splat, base, shard_n)
        return jax.lax.pmean(local + mine, "spp")

    step = shard_map(_shard_fn, mesh=mesh,
                     in_specs=(P(), P(), P()),
                     out_specs=P("px"), **_shard_map_kw())

    if pix_all is None:
        return _jit_with_crop(step, cfg)

    def full_film(scene, key, cnt):
        res = step(scene, key, cnt)              # (n_trace, 3) crop-local
        return jnp.zeros((cfg.n_pixels, 3), jnp.float32) \
            .at[pix_all].set(res)

    return jax.jit(full_film)


def render_pass_bdpt_transient_multichip(scene, cfg, mesh: Mesh):
    """Transient BDPT scaled over the 'spp' axis only.

    Each device runs the validated crop-local single-chip pass with its
    own RNG stream; the per-pass color is pmean'd and the time-bin
    histograms psum'd. Pixel sharding is deliberately NOT offered here:
    it would split the t=1 splat-bin targets across shards (a psum of
    the whole (N, T, 3) bins plane per strategy), and transient runs use
    small crop windows where sample-parallelism is the natural axis."""
    from ..renderer.bdpt import bdpt_pass_core
    from ..renderer.base import crop_pix_ids

    if mesh.shape["px"] != 1:
        raise ValueError(
            "transient BDPT multichip scales over independent sample "
            "batches: build the mesh with make_mesh(n, spp_parallel=n)")
    pix = crop_pix_ids(cfg)

    def _shard_fn(scene, key, cnt):
        spp_i = jax.lax.axis_index("spp")
        k = jax.random.fold_in(key, spp_i)
        if pix is None:
            local, splat, bins, cnts = bdpt_pass_core(scene, cfg, k, cnt)
            color = local + splat
        else:
            local, splat, bins, cnts = bdpt_pass_core(
                scene, cfg, k, cnt, pix_ids=pix, crop_local=True)
            color = splat.at[pix].add(local)
        return (jax.lax.pmean(color, "spp"),
                jax.lax.psum(bins, "spp"),
                jax.lax.psum(cnts, "spp"))

    step = shard_map(_shard_fn, mesh=mesh,
                     in_specs=(P(), P(), P()),
                     out_specs=(P(), P(), P()), **_shard_map_kw())
    return jax.jit(step)


class MultiChipRenderer:
    """Progressive renderer running one pass per step on every mesh device.

    Each host-level render() adds mesh.shape['spp'] samples per pixel."""

    _CHECK_KEYS = ("w", "h", "focal", "max_bounce",
                   "start_x", "end_x", "start_y", "end_y")

    def __init__(self, scene, cfg, mesh: Mesh, trace_fn=None, seed: int = 0,
                 bdpt: bool = False):
        self.scene = scene
        self.cfg = cfg
        self.mesh = mesh
        self.key = jax.random.PRNGKey(seed)
        self.color = jnp.zeros((cfg.n_pixels, 3), jnp.float32)
        self.cnt = 0
        self._kind = "bdpt" if bdpt else \
            getattr(trace_fn, "__name__", "trace_pt")
        self.is_transient = bool(bdpt and cfg.transient)
        if self.is_transient:
            assert trace_fn is None, "bdpt builds its own pass"
            from ..renderer.base import crop_pix_ids
            self._pix_ids = crop_pix_ids(cfg)
            n_traced = cfg.n_pixels if self._pix_ids is None \
                else int(self._pix_ids.shape[0])
            self.time_bins = jnp.zeros((n_traced, cfg.t_bins, 3),
                                       jnp.float32)
            self.time_cnts = jnp.zeros((n_traced, cfg.t_bins), jnp.int32)
            self._step = render_pass_bdpt_transient_multichip(scene, cfg,
                                                              mesh)
        elif bdpt:
            assert trace_fn is None, "bdpt builds its own pass"
            self._step = render_pass_bdpt_multichip(scene, cfg, mesh)
        else:
            if trace_fn is None:
                from ..renderer.pt import trace_pt
                trace_fn = trace_pt
            self._step = render_pass_multichip(scene, cfg, mesh, trace_fn)

    def render(self):
        self.cnt += self.mesh.shape["spp"]
        self.key, sub = jax.random.split(self.key)
        if self.is_transient:
            radiance, bins, cnts = self._step(self.scene, sub,
                                              jnp.int32(self.cnt))
            self.time_bins = self.time_bins + bins
            self.time_cnts = self.time_cnts + cnts
        else:
            radiance = self._step(self.scene, sub, jnp.int32(self.cnt))
        self.color = self.color + jnp.nan_to_num(radiance, nan=0.0) \
            * self.mesh.shape["spp"]
        return self.color

    # transient export API (shared helpers with renderer/bdpt.py BDPT)
    def copy_average(self, time_idx: int):
        from ..renderer.bdpt import transient_copy_average
        return transient_copy_average(self.cfg, self.time_bins,
                                      self.time_cnts, self._pix_ids,
                                      time_idx)

    def transient_frames(self):
        from ..renderer.bdpt import transient_frames_np
        return transient_frames_np(self.cfg, self.time_bins,
                                   self.time_cnts, self._pix_ids)

    def render_batch(self, n: int):
        """n host-level steps (mesh.shape['spp'] samples each)."""
        for _ in range(n):
            out = self.render()
        return out

    # -- checkpointing (same schema + consistency contract as
    # renderer/base.py; reference tracer/path_tracer.py:181-211) --
    def get_check_point(self) -> dict:
        chk = {k: getattr(self.cfg, k) for k in self._CHECK_KEYS}
        chk.update({
            "renderer": f"MultiChip-{self._kind}",
            "accumulation": np.asarray(self.color),
            "counter": self.cnt,
            "key": np.asarray(jax.random.key_data(self.key)),
        })
        if self.is_transient:
            from ..renderer.bdpt import transient_check_point
            chk.update(transient_check_point(self.cfg, self.time_bins,
                                             self.time_cnts))
        return chk

    def load_check_point(self, chk: dict):
        from ..renderer.bdpt import validate_transient_check_point
        want = f"MultiChip-{self._kind}"
        got = chk.get("renderer", want)
        if got != want:
            raise ValueError(f"checkpoint is from renderer '{got}', "
                             f"this run uses '{want}'")
        for k in self._CHECK_KEYS:
            if chk[k] != getattr(self.cfg, k):
                raise ValueError(
                    f"checkpoint config mismatch on '{k}': "
                    f"{chk[k]} != {getattr(self.cfg, k)}")
        # all validation (incl. transient payload) before any mutation
        bins, cnts = validate_transient_check_point(
            self.cfg, chk,
            self.time_bins.shape if self.is_transient else None,
            self.time_cnts.shape if self.is_transient else None,
            self.is_transient)
        self.color = jnp.asarray(chk["accumulation"])
        self.cnt = int(chk["counter"])
        self.key = jax.random.wrap_key_data(jnp.asarray(chk["key"]))
        if self.is_transient:
            self.time_bins = bins
            self.time_cnts = cnts

    @property
    def pixels(self):
        return (self.color / max(self.cnt, 1)).reshape(
            self.cfg.w, self.cfg.h, 3)

    def image(self):
        return np.asarray(jnp.swapaxes(self.pixels, 0, 1))[::-1]
