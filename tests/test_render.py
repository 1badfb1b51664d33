"""Forward renderer: golden properties of the jnp reference renderer."""
import jax
import jax.numpy as jnp
import numpy as np

from rtwc_tpu.camera import default_camera, Camera
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.render import render_frame, render_frame_soft
from rtwc_tpu.render.reference import MISS_DISTANCE
from rtwc_tpu.scene import default_scene, empty_scene, add_sphere

CFG = RenderConfig(width=120, height=80)


def test_render_shapes_and_ranges():
    fb = render_frame(default_scene(), default_camera(), CFG)
    assert fb.rgb.shape == (80, 120, 3)
    assert fb.depth.shape == (80, 120)
    rgb = np.asarray(fb.rgb)
    assert rgb.min() >= 0.0 and rgb.max() <= 255.0
    assert bool(fb.hit.any()), "default scene must be visible from the default pose"
    assert not bool(fb.hit.all())


def test_background_is_black_and_miss_depth():
    fb = render_frame(default_scene(), default_camera(), CFG)
    miss = ~np.asarray(fb.hit)
    assert (np.asarray(fb.rgb)[miss] == 0).all()
    # Rays that hit nothing carry the reference sentinel (RayTracing.h:21).
    depth = np.asarray(fb.depth)
    assert (depth[miss] >= 250.0).all()


def test_single_sphere_depth_closed_form():
    # Camera at origin looking +z (default pose); sphere straight ahead.
    s = empty_scene(8, 2)
    s = add_sphere(s, 7.0, (0.0, 0.0, 20.0), (255.0, 0.0, 0.0), speed=1.0)
    fb = render_frame(s, default_camera(), CFG)
    d = float(fb.depth[CFG.height // 2, CFG.width // 2])
    np.testing.assert_allclose(d, 13.0, rtol=1e-5)
    n = np.asarray(fb.normal[CFG.height // 2, CFG.width // 2])
    np.testing.assert_allclose(n, [0.0, 0.0, -1.0], atol=1e-5)


def test_closest_hit_wins():
    s = empty_scene(8, 2)
    s = add_sphere(s, 2.0, (0.0, 0.0, 30.0), (0.0, 255.0, 0.0), speed=1.0)  # far
    s = add_sphere(s, 2.0, (0.0, 0.0, 10.0), (255.0, 0.0, 0.0), speed=1.0)  # near
    fb = render_frame(s, default_camera(), CFG)
    d = float(fb.depth[CFG.height // 2, CFG.width // 2])
    np.testing.assert_allclose(d, 8.0, rtol=1e-5)


def test_render_is_jittable():
    f = jax.jit(render_frame, static_argnums=2)
    fb = f(default_scene(), default_camera(), CFG)
    assert bool(fb.hit.any())


def test_shading_value_is_normal_x():
    # ASCII shading drives off dot(normal, (1,0,0)) (RayTracing.cu:133).
    fb = render_frame(default_scene(), default_camera(), CFG)
    hit = np.asarray(fb.hit)
    np.testing.assert_allclose(
        np.asarray(fb.shading)[hit], np.asarray(fb.normal)[hit][:, 0], atol=1e-6
    )


def test_shadows_darken_only():
    cfg_s = CFG.replace(shadows=True)
    fb0 = render_frame(default_scene(), default_camera(), CFG)
    fb1 = render_frame(default_scene(), default_camera(), cfg_s)
    assert (np.asarray(fb1.rgb) <= np.asarray(fb0.rgb) + 1e-4).all()


def test_soft_converges_to_hard():
    # Small tau: soft forward approaches the hard reference image away from
    # silhouettes. Compare medians to be robust to edge pixels.
    scene, cam = default_scene(), default_camera()
    hard = render_frame(scene, cam, CFG)
    soft = render_frame_soft(scene, cam, CFG, tau=1e-3)
    diff = np.abs(np.asarray(soft.rgb) - np.asarray(hard.rgb))
    # 95% of pixels should agree closely.
    assert np.quantile(diff, 0.95) < 2.0, float(np.quantile(diff, 0.95))


def test_straight_through_forward_exact():
    scene, cam = default_scene(), default_camera()
    hard = render_frame(scene, cam, CFG)
    st = render_frame_soft(scene, cam, CFG, tau=0.05, straight_through=True)
    np.testing.assert_array_equal(np.asarray(st.rgb), np.asarray(hard.rgb))


def test_supersampled_frustum_matches_base():
    """supersampled_config keeps the frustum: the ss=2 render box-filtered
    down must agree with the base render away from silhouette edges."""
    from rtwc_tpu.render import downsample_framebuffer, supersampled_config

    scene, cam = default_scene(), default_camera()
    cfg = CFG.replace(supersample=2)
    fb_base = render_frame(scene, cam, CFG)
    fb_hi = render_frame(scene, cam, supersampled_config(cfg))
    assert fb_hi.rgb.shape == (160, 240, 3)
    fb_aa = downsample_framebuffer(fb_hi, 2)
    assert fb_aa.rgb.shape == fb_base.rgb.shape
    # Interior pixels (all 4 subsamples hit, neighbors hit too) must match
    # the single-ray render closely; edges differ by design (that's the AA).
    base = np.asarray(fb_base.rgb)
    aa = np.asarray(fb_aa.rgb)
    hit4 = np.asarray(fb_hi.hit).reshape(80, 2, 120, 2).all(axis=(1, 3))
    interior = hit4 & np.asarray(fb_base.hit)
    assert interior.sum() > 100
    err = np.abs(aa[interior] - base[interior])
    assert np.percentile(err, 90) < 8.0, err.max()


def test_supersample_smooths_edges():
    """AA must strictly reduce the count of fully-black<->lit hard steps
    along silhouettes: edge cells become intermediate."""
    from rtwc_tpu.render import downsample_framebuffer, supersampled_config

    s = empty_scene(8, 2)
    s = add_sphere(s, 7.0, (0.0, 0.0, 20.0), (255.0, 0.0, 0.0), speed=1.0)
    cam = default_camera()
    cfg = CFG.replace(supersample=4)
    fb_hi = render_frame(s, cam, supersampled_config(cfg))
    fb_aa = downsample_framebuffer(fb_hi, 4)
    r = np.asarray(fb_aa.rgb[..., 0])
    hitf = np.asarray(fb_hi.hit).reshape(80, 4, 120, 4).mean(axis=(1, 3))
    partial = (hitf > 0.0) & (hitf < 1.0)
    assert partial.sum() > 20, "a sphere silhouette must produce partial cells"
    assert (r[partial] > 0.0).all(), "partial cells must not be pure background"
    # depth on partial cells stays finite (hit-weighted mean, no sentinel bleed)
    assert (np.asarray(fb_aa.depth)[partial] < 2.0 * 250.0).all()


def test_supersample_partial_cells_display_color():
    """Regression: the DISPLAY path must keep the AA blend on
    silhouette cells with <50% coverage - the mode head masks color by
    coverage > 0, not by the majority hit rule (which still drives glyphs)."""
    from rtwc_tpu.config import RenderMode
    from rtwc_tpu.heads import framebuffer_to_cells
    from rtwc_tpu.render import downsample_framebuffer, supersampled_config

    s = empty_scene(8, 2)
    s = add_sphere(s, 7.0, (0.0, 0.0, 20.0), (255.0, 0.0, 0.0), speed=1.0)
    cam = default_camera()
    cfg = CFG.replace(supersample=4, mode=RenderMode.RGB_PIXEL)
    fb_aa = downsample_framebuffer(render_frame(s, cam, supersampled_config(cfg)), 4)
    cov = np.asarray(fb_aa.coverage)
    minority = (cov > 0.0) & (cov < 0.5)
    assert minority.sum() > 0, "need sub-majority silhouette cells"
    _, color, _ = framebuffer_to_cells(fb_aa, cfg)
    col = np.asarray(color)
    assert (col[minority].sum(axis=-1) > 0).all(), (
        "sub-majority-coverage cells must display the AA blend, not black"
    )
    # and pooled color excludes beyond-far subsample color: where nothing
    # hits, the cell is exactly black
    assert (col[cov == 0.0] == 0).all()


def test_engine_supersample_mode_runs():
    from rtwc_tpu.config import EngineConfig
    from rtwc_tpu.engine import Engine
    from rtwc_tpu.io import FramebufferSink

    rcfg = RenderConfig(width=40, height=24, supersample=2, max_spheres=16, max_planes=4)
    sink = FramebufferSink(keep_all=True)
    eng = Engine(rcfg, EngineConfig(spawn=False, show_fps=False),
                 presenter=sink, interactive=False)
    eng.run(max_frames=2)
    assert len(sink.frames) == 2 and sink.frames[-1].count(b"\n") == 24
