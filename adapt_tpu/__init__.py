"""adapt_tpu: a JAX/XLA/Pallas physically-based wavefront path tracing
framework with the capabilities of the AdaPT reference renderer."""

__version__ = "0.1.0"

import jax as _jax

# Geometry predicates need f32-exact dot products, and ops/gather.py's
# one-hot lookups pass table values through a 0/1 matmul that must return
# them bit-exactly. On an H100 a float32 matmul may run in TF32, which
# keeps 10 mantissa bits: that produces false self-intersections at
# RAY_EPS scale and rounds looked-up values. 'highest' keeps full f32.
_jax.config.update("jax_default_matmul_precision", "highest")

from .scene.compile import load_scene, compile_scene, SceneData, RenderConfig
