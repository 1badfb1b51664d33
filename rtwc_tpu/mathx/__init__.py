"""Thin math helpers over jnp.

The reference carries a 357-line hand-rolled vector/matrix library
(MyMath.h/.cu) because CUDA needs __host__ __device__ types. Under JAX this
layer dissolves into XLA: jnp ops ARE the math library. Only the few
helpers that encode reference-specific semantics live here.
"""
from rtwc_tpu.mathx.core import (
    normalize,
    safe_normalize,
    dot,
    pytree_dataclass,
)

__all__ = ["normalize", "safe_normalize", "dot", "pytree_dataclass"]
