"""Test-session environment: CPU JAX with 8 virtual devices.

Multi-device sharding is validated on a simulated 8-device CPU mesh
(SURVEY.md section 4: "Multi-chip without a cluster"). The platform is set
through jax.config before the backend initializes - which is why this
lives in the root conftest, imported before any test module touches jax.
Tests that need the GPU carry the `gpu` marker and skip here; chip_smoke.py
runs them on the card.
"""
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
