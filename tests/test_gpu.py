"""Card-only tests: the kernels compiled for the GPU against the jnp
references, at small sizes. They need a GPU and skip elsewhere;
chip_smoke.py runs them on the card (README, "Running on the GPU")."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtwc_tpu.camera import Camera, default_camera
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.scene import default_scene, random_scene

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this on the card")


def test_hard_kernel_compiled_matches_reference(gpu):
    from chip_smoke import hard_parity
    from rtwc_tpu.render import render_frame
    from rtwc_tpu.render.pallas_kernel import render_frame_pallas

    for shadows in (False, True):
        cfg = RenderConfig(width=400, height=150, shadows=shadows)
        scene, cam = default_scene(cfg), default_camera()
        hard_parity(render_frame(scene, cam, cfg),
                    render_frame_pallas(scene, cam, cfg))


def test_fused_kernel_compiled_matches_reference(gpu):
    from chip_smoke import tree_parity
    from rtwc_tpu.render import render_frame_soft
    from rtwc_tpu.render.pallas_soft import render_soft_mse_loss

    cfg = RenderConfig(width=320, height=180, max_spheres=8, max_planes=4,
                       shadows=True, soft_miss_penalty=300.0, soft_mask_k=10.0)
    scene = random_scene(6, max_spheres=8, max_planes=4, seed=2)
    cam = Camera(pos=jnp.asarray(default_camera().pos),
                 rot=jnp.asarray(default_camera().rot))
    target = jnp.full((cfg.height, cfg.width, 3), 80.0, jnp.float32)

    def ref(sc):
        rgb = render_frame_soft(sc, cam, cfg, tau=0.5).rgb
        return jnp.mean(((rgb - target) / 255.0) ** 2)

    lr, gr = jax.jit(jax.value_and_grad(ref))(scene)
    lk, gk = jax.jit(jax.value_and_grad(
        lambda sc: render_soft_mse_loss(sc, cam, target, cfg, tau=0.5)))(scene)
    assert abs(float(lk) - float(lr)) <= 1e-4 * abs(float(lr))
    tree_parity(gr, gk)


def test_gpu_uses_kernels_without_fallback(gpu):
    """On the GPU the backend choice picks the kernels, and the lowered
    display step holds the compiled Triton kernel (no interpreter)."""
    from rtwc_tpu.engine.engine import _render_step
    from rtwc_tpu.render.backend import use_kernels

    assert use_kernels()
    cfg = RenderConfig(width=64, height=32, max_spheres=8, max_planes=2)
    text = _render_step.lower(default_scene(cfg), default_camera(),
                              np.float32(0.0), cfg).as_text()
    assert "xla.gpu.triton" in text
