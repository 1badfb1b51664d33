"""The one place that decides which renderer a platform runs.

On the GPU every hot path runs its compiled Pallas kernel
(render/pallas_kernel.py, render/pallas_soft.py, Triton route). On the
CPU the plain jnp renderers (render/reference.py, render/softmin.py) run:
they are the semantic reference the kernels are tested against, and the
kernels reach the CPU only in interpret mode, which tests ask for
explicitly. Any other platform is an error - nothing falls back quietly.
"""
from __future__ import annotations

import jax


def use_kernels(platform: str | None = None) -> bool:
    """True on the GPU (compiled kernels), False on the CPU (jnp
    reference); raises on any other platform. `platform` defaults to
    jax.default_backend()."""
    platform = jax.default_backend() if platform is None else platform
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise RuntimeError(
        f"no renderer for platform {platform!r}: the kernels target the "
        f"GPU (Triton route) and the jnp reference runs on the CPU")
