"""Hard Pallas kernel vs jnp reference renderer: golden allclose tests
(SURVEY.md section 4). Here the Triton-route kernel runs in the Pallas
interpreter; chip_smoke.py makes the same comparison with the kernel
compiled for the GPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtwc_tpu.camera import Camera, default_camera
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.render import render_frame
from rtwc_tpu.render.pallas_kernel import render_frame_pallas
from rtwc_tpu.render.pack import pack_scene, pack_camera
from rtwc_tpu.scene import default_scene, random_scene, empty_scene, add_sphere

CFG = RenderConfig(width=120, height=48, max_spheres=16, max_planes=4)


def _compare(scene, cam, cfg, atol=2e-3):
    ref = render_frame(scene, cam, cfg)
    ker = render_frame_pallas(scene, cam, cfg, interpret=True)
    hit_ref = np.asarray(ref.hit)
    hit_ker = np.asarray(ker.hit)
    # hit masks may differ on a measure-zero silhouette set; require ~equal
    frac = np.mean(hit_ref != hit_ker)
    assert frac < 0.005, f"hit masks differ on {frac:.1%} of pixels"
    both = hit_ref & hit_ker
    for name in ("rgb", "depth", "normal", "shading"):
        a = np.asarray(getattr(ref, name))[both]
        b = np.asarray(getattr(ker, name))[both]
        np.testing.assert_allclose(a, b, atol=atol, rtol=1e-4, err_msg=name)


def test_pack_scene_compacts():
    s = empty_scene(8, 2)
    s = add_sphere(s, 2.0, (1, 2, 3), (9, 9, 9), speed=1.0)
    sph, pl, counts = pack_scene(s)
    assert sph.shape == (8, 8) and pl.shape == (12, 2)
    assert counts.tolist() == [1, 0]
    np.testing.assert_allclose(np.asarray(sph[:3, 0]), [1, 2, 3])


def test_pallas_matches_reference_default_scene():
    _compare(default_scene(CFG), default_camera(), CFG)


def test_pallas_matches_reference_posed_camera():
    cam = Camera(pos=jnp.array([3.0, 2.0, -5.0]), rot=jnp.array([0.25, 2.8, 0.0]))
    _compare(default_scene(CFG), cam, CFG)


def test_pallas_matches_reference_random_scene():
    scene = random_scene(10, 1, max_spheres=16, max_planes=4, seed=3)
    _compare(scene, default_camera(), CFG)


def test_pallas_matches_with_shadows():
    cfg = CFG.replace(shadows=True)
    _compare(default_scene(cfg), default_camera(), cfg)


def test_pallas_nondivisible_resolution():
    cfg = CFG.replace(width=100, height=37)
    _compare(default_scene(cfg), default_camera(), cfg)


def test_pallas_empty_scene_is_background():
    s = empty_scene(8, 2)
    fb = render_frame_pallas(s, default_camera(), CFG, interpret=True)
    assert not bool(np.asarray(fb.hit).any())
    assert (np.asarray(fb.rgb) == 0).all()
