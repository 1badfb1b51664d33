"""Fused one-pass MSE kernel vs the jnp soft renderer (golden strategy,
SURVEY.md section 4): the loss value AND the gradients of every trainable
parameter group (spheres, planes, colors, camera pose, shadow occluders)
of render_soft_mse_loss must match jnp render_frame_soft + MSE. On the
CPU the kernel runs in the Pallas interpreter (Triton route)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtwc_tpu.camera import Camera, default_camera
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.render import render_frame_soft
from rtwc_tpu.render.pallas_soft import render_soft_mse_loss
from rtwc_tpu.scene import add_plane, add_sphere, empty_scene, random_scene

CFG = RenderConfig(width=96, height=32, max_spheres=4, max_planes=2,
                   soft_miss_penalty=300.0, soft_mask_k=10.0)
CFG_SH = CFG.replace(shadows=True)
TAU = 0.5


def _scene():
    s = empty_scene(CFG.max_spheres, CFG.max_planes)
    s = add_sphere(s, 5.0, (0.0, 1.0, 20.0), (200.0, 40.0, 40.0), speed=1.0)
    s = add_sphere(s, 3.0, (-4.0, -1.0, 28.0), (40.0, 200.0, 40.0), speed=1.0)
    s = add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0), 60.0, 60.0)
    return s


def _scene_shadowed():
    """Occluder sphere between the light (above, at y=50) and the others."""
    return add_sphere(_scene(), 3.0, (-2.0, 8.0, 22.0), (40.0, 40.0, 200.0),
                      speed=1.0)


def _camera():
    return Camera(pos=jnp.asarray(default_camera().pos),
                  rot=jnp.asarray(default_camera().rot))


def _target(cfg, seed=1):
    return jax.random.uniform(jax.random.PRNGKey(seed),
                              (cfg.height, cfg.width, 3)) * 255.0


def _jnp_loss(cfg, target):
    def loss(scene, cam):
        fb = render_frame_soft(scene, cam, cfg, tau=TAU)
        return jnp.mean(((fb.rgb - target) / 255.0) ** 2)
    return loss


def _kernel_loss(cfg, target, cull=True):
    def loss(scene, cam):
        return render_soft_mse_loss(scene, cam, target, cfg, tau=TAU,
                                    interpret=True, cull=cull)
    return loss


def _value_and_grads(loss, scene, cam):
    return jax.value_and_grad(loss, argnums=(0, 1))(scene, cam)


@functools.lru_cache(maxsize=None)
def _pair(shadows: bool):
    """((loss, grads) jnp, (loss, grads) kernel) on the standard scene."""
    cfg = CFG_SH if shadows else CFG
    scene = _scene_shadowed() if shadows else _scene()
    cam, target = _camera(), _target(cfg)
    return (_value_and_grads(_jnp_loss(cfg, target), scene, cam),
            _value_and_grads(_kernel_loss(cfg, target), scene, cam))


def _assert_close_tree(ga, gb, rtol=2e-2, atol=1e-6, what=""):
    for a, b in zip(jax.tree.leaves(ga), jax.tree.leaves(gb)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = np.maximum(np.abs(a), np.abs(b))
        bad = np.abs(a - b) > (atol + rtol * scale)
        assert not bad.any(), f"{what}: grad mismatch\njnp={a[bad][:5]}\nker={b[bad][:5]}"


def _assert_loss_close(lj, lp, rtol=1e-5):
    assert abs(float(lp) - float(lj)) <= rtol * abs(float(lj)), (float(lj), float(lp))


def test_forward_matches_jnp_soft():
    (lj, _), (lp, _) = _pair(False)
    _assert_loss_close(lj, lp)


def test_forward_nondefault_counts():
    """Count-dependent loop: fewer live objects than capacity (and a
    capacity that is not a power of two: the wrapper pads the tables)."""
    cfg = CFG.replace(max_spheres=7, max_planes=3)
    s = empty_scene(7, 3)
    s = add_sphere(s, 4.0, (2.0, 0.0, 15.0), (10.0, 220.0, 10.0), speed=1.0)
    cam, target = _camera(), _target(cfg)
    lj, gj = _value_and_grads(_jnp_loss(cfg, target), s, cam)
    lp, gp = _value_and_grads(_kernel_loss(cfg, target), s, cam)
    _assert_loss_close(lj, lp)
    _assert_close_tree(gj[0].spheres.center, gp[0].spheres.center, what="centers")


def test_grads_match_jnp_scene():
    (_, (gj, _)), (_, (gp, _)) = _pair(False)
    _assert_close_tree(gj.spheres.center, gp.spheres.center, what="sphere centers")
    _assert_close_tree(gj.spheres.radius, gp.spheres.radius, what="sphere radii")
    _assert_close_tree(gj.spheres.color, gp.spheres.color, what="sphere colors")
    _assert_close_tree(gj.planes.normal, gp.planes.normal, what="plane normals")
    _assert_close_tree(gj.planes.center, gp.planes.center, what="plane centers")
    _assert_close_tree(gj.planes.width, gp.planes.width, what="plane widths")
    _assert_close_tree(gj.planes.color, gp.planes.color, what="plane colors")


def test_grads_match_jnp_camera():
    (_, (_, cj)), (_, (_, cp)) = _pair(False)
    _assert_close_tree(cj.pos, cp.pos, what="camera pos")
    _assert_close_tree(cj.rot, cp.rot, what="camera rot")


def test_grads_finite():
    for shadows in (False, True):
        _, (_, g) = _pair(shadows)
        for leaf in jax.tree.leaves(g):
            assert np.isfinite(np.asarray(leaf)).all()


def test_shadow_forward_matches_jnp_soft():
    (lj, _), (lp, _) = _pair(True)
    _assert_loss_close(lj, lp)


def test_shadow_darkens():
    """The occluder must actually cast a shadow: against the unshadowed
    image as target, the unshadowed kernel loss is ~0 and the shadowed
    one is not."""
    scene, cam = _scene_shadowed(), _camera()
    lit = render_frame_soft(scene, cam, CFG, tau=TAU).rgb
    l_lit = float(_kernel_loss(CFG, lit)(scene, cam))
    l_sh = float(_kernel_loss(CFG_SH, lit)(scene, cam))
    assert l_lit < 1e-9, l_lit
    assert l_sh > 1e3 * max(l_lit, 1e-12), (l_lit, l_sh)


def test_shadow_grads_match_jnp():
    (_, (gj, cj)), (_, (gp, cp)) = _pair(True)
    # atol 5e-6: the shadow chain adds cancellation-prone f32 sums whose
    # near-zero components carry ~2e-6 path-order noise (real components
    # sit at 1e-2..1e-1 and are held to the 2% rtol).
    kw = dict(atol=5e-6)
    _assert_close_tree(gj.spheres.center, gp.spheres.center, what="sphere centers", **kw)
    _assert_close_tree(gj.spheres.radius, gp.spheres.radius, what="sphere radii", **kw)
    _assert_close_tree(gj.spheres.color, gp.spheres.color, what="sphere colors", **kw)
    _assert_close_tree(gj.planes.center, gp.planes.center, what="plane centers", **kw)
    _assert_close_tree(gj.planes.normal, gp.planes.normal, what="plane normals", **kw)
    _assert_close_tree(cj.pos, cp.pos, what="camera pos", **kw)
    _assert_close_tree(cj.rot, cp.rot, what="camera rot", **kw)


def test_shadow_forward_saturating_clamp_fallback():
    """Specular-saturated lighting: bright tiles have objects with
    A_k + B_k >= 255, so the exact clamped re-walk matters. Loss AND
    gradients must still match the jnp renderer."""
    cfg = CFG_SH.replace(light_specular_power=3e5, light_diffuse_power=2e4)
    scene, cam = _scene_shadowed(), _camera()
    assert (np.asarray(render_frame_soft(scene, cam, cfg, tau=TAU).rgb)
            >= 254.5).any(), "clamp never fired"
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    lj, (gj, _) = _value_and_grads(_jnp_loss(cfg, target), scene, cam)
    lp, (gp, _) = _value_and_grads(_kernel_loss(cfg, target), scene, cam)
    _assert_loss_close(lj, lp)
    _assert_close_tree(gj.spheres.center, gp.spheres.center,
                       what="sphere centers (saturated)", atol=5e-6)
    _assert_close_tree(gj.spheres.color, gp.spheres.color,
                       what="sphere colors (saturated)", atol=5e-6)


def test_shadow_forward_cache_overflow_rewalk():
    """A dense tile: 40 overlapping spheres, all in frame, so every tile
    lists and re-walks dozens of objects in the shadowed forward. The
    loss must still match the jnp renderer."""
    rng = np.random.default_rng(3)
    s = empty_scene(48, 2)
    for _ in range(40):
        s = add_sphere(s, float(rng.uniform(2.0, 4.0)),
                       (float(rng.uniform(-4, 4)), float(rng.uniform(-2, 2)),
                        float(rng.uniform(18, 30))),
                       tuple(float(c) for c in rng.uniform(30, 220, 3)),
                       speed=1.0)
    cfg = CFG_SH.replace(max_spheres=48)
    cam, target = _camera(), _target(cfg)
    lj = _jnp_loss(cfg, target)(s, cam)
    lp = _kernel_loss(cfg, target)(s, cam)
    # 40 overlapping objects stack ~8x more softmin terms than the other
    # scenes; online-vs-batch summation order costs ~1e-4 relative in rgb.
    _assert_loss_close(lj, lp, rtol=1e-4)


def test_shadow_occluder_gets_grad_through_shadow_only():
    """An occluder OUTSIDE the view frustum still receives gradients via
    the shadow term alone - the capability the hard renderer cannot have."""
    s = empty_scene(CFG.max_spheres, CFG.max_planes)
    s = add_sphere(s, 5.0, (0.0, 1.0, 20.0), (200.0, 40.0, 40.0), speed=1.0)
    # far above the camera frustum, grazing the segments from the sphere's
    # hit points to the light at (1, 50, 0)
    s = add_sphere(s, 4.0, (3.5, 26.0, 10.0), (40.0, 40.0, 200.0), speed=1.0)
    cam = default_camera()
    target = jnp.zeros((CFG.height, CFG.width, 3), jnp.float32)
    g = jax.grad(lambda sc: _kernel_loss(CFG_SH, target)(sc, cam))(s)
    gj = jax.grad(lambda sc: _jnp_loss(CFG_SH, target)(sc, cam))(s)
    g_occ = np.asarray(g.spheres.center)[1]
    assert np.abs(g_occ).max() > 0.0, "occluder grads must flow through vis"
    _assert_close_tree(gj.spheres.center[1], g.spheres.center[1],
                       what="occluder", atol=5e-6)


def test_inactive_slots_zero_grad():
    """Dead pool slots get exactly zero gradient; every live sphere the
    jnp renderer gives a gradient above float noise gets one from the
    kernel too (a live sphere whose softmin weight stays below the
    exp(-16) culling floor everywhere is culled: exactly zero)."""
    (_, (gj, _)), (_, (g, _)) = _pair(False)
    scene = _scene()
    live = np.asarray(scene.spheres.active) > 0.5
    gc = np.asarray(g.spheres.center)
    seen = np.abs(np.asarray(gj.spheres.center)).sum(axis=-1) > 1e-6
    assert (gc[~live] == 0).all()
    assert seen[live].any()
    assert (np.abs(gc[live & seen]).sum(axis=-1) > 0).all()


def test_twofloat_plane_sum():
    """The in-kernel compensated plane reduction used for the camera-basis
    cotangents (pallas_soft._twofloat_plane_sum, halving folds on the
    Triton route) is exact to double-float precision on adversarially
    scaled inputs - where a plain f32 sum carries ~1e-7 relative error."""
    from jax.experimental import pallas as pl

    from rtwc_tpu.render.pallas_soft import _twofloat_plane_sum

    def kern(x_ref, o_ref):
        hi, lo = _twofloat_plane_sum(x_ref[...])
        iota = jax.lax.broadcasted_iota(jnp.int32, (2,), 0)
        o_ref[...] = jnp.where(iota == 0, hi, lo)

    def run(x):
        return pl.pallas_call(
            kern, out_shape=jax.ShapeDtypeStruct((2,), jnp.float32),
            backend="triton", interpret=True)(x)

    rng = np.random.RandomState(0)
    for shape in [(16, 32), (8, 128), (32, 32), (1, 64)]:
        x = (rng.randn(*shape) * np.exp(rng.randn(*shape) * 4.0)).astype(np.float32)
        out = np.asarray(run(jnp.asarray(x)))
        truth = float(np.sum(x.astype(np.float64)))
        got = float(out[0]) + float(out[1])
        assert abs(got - truth) <= 1e-10 * abs(truth), (shape, got, truth)


def test_two_level_culling_is_conservative():
    """Culled (broad-phase work lists + in-kernel bound gates) and fully
    unculled kernels agree to float noise, loss and gradients: every
    excluded object was genuinely below the softmin weight floor / shadow
    sigmoid floor, on scenes with spheres scattered in and out of the
    frustum. A non-conservative exclusion would drop a competitor above
    the exp(-16) floor and show as an O(1) change at the affected pixels."""
    for seed in (0, 7):
        scene = random_scene(24, max_spheres=24, max_planes=4, seed=seed)
        cam = _camera()
        for shadows in (False, True):
            cfg = CFG.replace(shadows=shadows, max_spheres=24)
            target = _target(cfg, seed)
            lc, (gc, _) = _value_and_grads(_kernel_loss(cfg, target, True), scene, cam)
            ln, (gn, _) = _value_and_grads(_kernel_loss(cfg, target, False), scene, cam)
            _assert_loss_close(ln, lc, rtol=1e-6)
            _assert_close_tree(gn.spheres.center, gc.spheres.center,
                               what="culled vs unculled centers", atol=1e-7)


@pytest.mark.parametrize("shadows,cull", [(False, True), (True, True),
                                          (True, False)])
def test_fused_mse_loss_matches_generic(shadows, cull):
    """render_soft_mse_loss computes the same loss AND the same
    scene/camera gradients as the jnp render + MSE, culled or not; and
    the target cotangent is the (negative) rgb cotangent."""
    cfg = CFG.replace(shadows=shadows)
    scene, cam, target = _scene(), _camera(), _target(cfg)
    lg, gg = _value_and_grads(_jnp_loss(cfg, target), scene, cam)
    lf, gf = _value_and_grads(_kernel_loss(cfg, target, cull), scene, cam)
    _assert_loss_close(lg, lf)
    for a, b, name in (
        (gg[0].spheres.center, gf[0].spheres.center, "center"),
        (gg[0].spheres.radius, gf[0].spheres.radius, "radius"),
        (gg[0].spheres.color, gf[0].spheres.color, "color"),
        (gg[0].planes.center, gf[0].planes.center, "pcenter"),
        (gg[1].pos, gf[1].pos, "campos"),
        (gg[1].rot, gf[1].rot, "camrot"),
    ):
        _assert_close_tree(a, b, what=name)

    gt = jax.grad(lambda t: render_soft_mse_loss(scene, cam, t, cfg, tau=TAU,
                                                 interpret=True))(target)
    # the rule's rgb comes from the jitted jnp forward: compare with the
    # same (eager op-by-op dispatch rounds silhouette pixels differently)
    rgb = jax.jit(lambda sc, c: render_frame_soft(sc, c, cfg, tau=TAU).rgb)(
        scene, cam)
    want = -2.0 / (255.0 ** 2 * target.size) * (rgb - target)
    np.testing.assert_allclose(np.asarray(gt), np.asarray(want),
                               rtol=1e-4, atol=1e-12)


def test_shadow_early_out_full_darkness():
    """All-dark early-out (_shadow_vis_sweep): a huge occluder slab
    between the light and the whole scene drives every ray's vis to the
    transmittance floor, activating the early-out (remaining occluders
    skipped). The loss must stay within the documented _VIS_EARLY_OUT
    bound of the jnp renderer, and gradients must stay finite."""
    s = _scene()
    s = add_plane(s, (0.0, 20.0, 28.0), (0.0, 1.0, 0.0),
                  (90.0, 90.0, 90.0), 500.0, 500.0)
    s = add_sphere(s, 2.0, (-2.0, 8.0, 24.0), (40.0, 40.0, 200.0), speed=1.0)
    cfg = CFG_SH.replace(max_planes=4)
    cam = default_camera()
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    lj = _jnp_loss(cfg, target)(s, cam)
    lp, g = _value_and_grads(_kernel_loss(cfg, target), s, cam)
    _assert_loss_close(lj, lp, rtol=1e-4)
    for leaf in jax.tree.leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()


def _lists_setup(cfg, s):
    from rtwc_tpu.render import pack as P_
    from rtwc_tpu.render import tiles

    bh, bw = tiles.pick_tile(cfg.height, cfg.width)
    grid = (tiles.round_up(cfg.height, bh) // bh,
            tiles.round_up(cfg.width, bw) // bw)
    sph, pl_, counts = P_.pack_scene(s)
    cam_v = P_.pack_camera(default_camera())
    return sph, pl_, cam_v, bh, bw, grid


def test_depth_bounded_shadow_lists_conservative():
    """The depth-bounded shadow broad phase: an occluder BEYOND every
    possible hit depth of a plane-covered tile (but inside the full
    [0, far] hull) must be excluded from that tile's shadow list without
    changing the loss - and a genuinely relevant occluder must stay."""
    from rtwc_tpu.render import tiles

    cfg = CFG_SH.replace(far=100.0)
    s = _scene()  # spheres at z 20-28, ground plane
    s = add_sphere(s, 2.0, (0.0, 20.0, 80.0), (90.0, 90.0, 90.0), speed=1.0)
    sph, pl_, cam_v, bh, bw, grid = _lists_setup(cfg, s)
    _, aux = tiles.sphere_tile_lists(sph, cam_v, cfg, TAU, bh, bw, grid)
    shl = np.asarray(tiles.shadow_tile_lists(sph, pl_, cam_v, cfg, TAU, bh,
                                             bw, grid, view_aux=aux))
    far_occ = 3  # index of the added far occluder
    in_lists = [set(row[1:1 + row[0]].tolist()) for row in shl]
    assert any(far_occ not in lst for lst in in_lists), (
        "depth bound never excluded the far occluder")
    cam, target = _camera(), _target(cfg)
    lc = _kernel_loss(cfg, target, True)(s, cam)
    ln = _kernel_loss(cfg, target, False)(s, cam)
    _assert_loss_close(ln, lc, rtol=1e-6)


def test_plane_depth_bounds_certificates():
    """plane_depth_bounds unit cases: a tile looking at a covering
    ground plane is certified covered with a finite depth bound; a tile
    looking AWAY from every plane gets the strict-sky certificate."""
    from rtwc_tpu.render import tiles

    sph, pl_, cam_v, bh, bw, grid = _lists_setup(CFG_SH, _scene())
    _, _, d_raw = tiles.tile_cones(cam_v, CFG_SH, bh, bw, grid)
    t_hi, covered, sky = tiles.plane_depth_bounds(pl_, cam_v, CFG_SH, TAU, d_raw)
    t_hi, covered, sky = (np.asarray(t_hi), np.asarray(covered),
                          np.asarray(sky))
    assert (t_hi >= 0.0).all() and (t_hi <= CFG_SH.far).all()
    if covered.any():
        assert (t_hi[covered] < CFG_SH.far).all()
    assert not (covered & sky).any()
