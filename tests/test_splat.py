"""BDPT t=1 film splat (renderer/bdpt.py splat_sorted, the scatter-add
every backend uses) against a numpy np.add.at oracle."""
import numpy as np
import jax.numpy as jnp
import pytest

from adapt_tpu.renderer.bdpt import splat_sorted

P = 257          # film pixels (odd, so no id pattern lines up with it)


def _case(name, rng):
    """(ids, rgb) for one splat stream."""
    if name == "colliding":          # many splats onto a few pixels
        ids = rng.choice([0, 5, 5, 17, P - 1], 600)
    elif name == "outside_crop":     # lanes the rasterizer dropped
        ids = rng.integers(-3, P + 4, 600)
        ids[::7] = P                 # the callers' `drop` id
    elif name == "zero_weights":     # splats carrying no radiance
        ids = rng.integers(0, P, 600)
    elif name == "all_dropped":
        ids = np.full(64, P)
    else:                            # "random": unsorted, every pixel
        ids = rng.integers(0, P, 5000)
    rgb = rng.uniform(0.0, 2.0, (ids.shape[0], 3)).astype(np.float32)
    if name == "zero_weights":
        rgb[rng.random(ids.shape[0]) < 0.7] = 0.0
    return ids.astype(np.int32), rgb


CASES = ["colliding", "outside_crop", "zero_weights", "all_dropped",
         "random"]


@pytest.mark.parametrize("name", CASES)
def test_splat_matches_add_at(name):
    rng = np.random.default_rng(CASES.index(name))
    film = rng.uniform(0.0, 1.0, (P, 3)).astype(np.float32)
    ids, rgb = _case(name, rng)
    got = np.asarray(splat_sorted(jnp.asarray(film), jnp.asarray(ids),
                                  jnp.asarray(rgb)))
    ref = film.astype(np.float64)
    keep = (ids >= 0) & (ids < P)
    np.add.at(ref, ids[keep], rgb[keep].astype(np.float64))
    # exact up to f32 summation order
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if name == "all_dropped":
        np.testing.assert_array_equal(got, film)
