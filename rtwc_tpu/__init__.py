"""rtwc_tpu: a differentiable console ray tracer.

A brand-new JAX / XLA / Pallas framework with the capabilities of the CUDA
console ray tracer EmilHogstedt/Raytracing-in-Windows-Console (see SURVEY.md
for the structural analysis it was designed against). Not a port: the scene
is a struct-of-arrays pytree, rendering is a pure differentiable function,
the hot path is a fused Pallas kernel (Triton route, for the GPU), and the
ray/tile axis shards over a device mesh.
"""
from rtwc_tpu.config import RenderConfig, EngineConfig, RenderMode

__version__ = "0.1.0"

__all__ = ["RenderConfig", "EngineConfig", "RenderMode", "__version__"]
