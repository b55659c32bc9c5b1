"""Process set-up shared by every entry point: the JAX platform pin and
the persistent compilation cache."""
from __future__ import annotations

import os

# the checkout holding this package (adapt_tpu/utils/runtime.py -> root)
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV_CACHE = "JAX_COMPILATION_CACHE_DIR"
# --arch value -> jax_platforms: "gpu" pins CUDA, so a machine without a
# card fails at start-up instead of rendering on the CPU
PLATFORMS = {"gpu": "cuda", "cpu": "cpu"}


def compile_cache_dir() -> str:
    """Where compiled programs are cached: $JAX_COMPILATION_CACHE_DIR if
    set, otherwise <checkout>/.jax_cache (a fixed path, so the cache key
    stays the same from run to run)."""
    return os.environ.get(ENV_CACHE) or os.path.join(CHECKOUT, ".jax_cache")


def setup_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.
    With $JAX_COMPILATION_CACHE_DIR set JAX reads it itself and nothing
    else is set here."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_CACHE):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def pin_platform(arch: str) -> None:
    """Pin the JAX platform for --arch {gpu, cpu}; call before the first
    device use."""
    import jax
    jax.config.update("jax_platforms", PLATFORMS[arch])
