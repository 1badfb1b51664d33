"""Simulated-mesh distributed tests (8 virtual CPU devices via conftest.py;
SURVEY.md section 4 'multi-chip without a cluster')."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtwc_tpu.camera import default_camera
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.dist import make_mesh, render_frame_sharded, make_sharded_train_step
from rtwc_tpu.render import render_frame, render_frame_soft
from rtwc_tpu.scene import default_scene

CFG = RenderConfig(width=64, height=32, max_spheres=16, max_planes=4)


def test_virtual_mesh_available():
    assert jax.device_count() >= 8, "conftest must force 8 virtual CPU devices"


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_render_matches_single_device(n):
    # Tile-sharded output must match the single-device render. Tolerance is
    # last-bit only: shard_map compiles per-band programs whose fusion
    # differs from the monolithic one, so exact bit equality is not
    # guaranteed across XLA programs - but every pixel must round-trip
    # through the 8-bit encoder identically (atol << 1/2 LSB of u8 color).
    mesh = make_mesh(n)
    scene, cam = default_scene(CFG), default_camera()
    fb_single = render_frame(scene, cam, CFG)
    fb_sharded = render_frame_sharded(scene, cam, CFG, mesh)
    for name, atol in (("rgb", 1e-3), ("normal", 1e-5), ("depth", 1e-2), ("shading", 1e-5)):
        np.testing.assert_allclose(
            np.asarray(getattr(fb_single, name)),
            np.asarray(getattr(fb_sharded, name)),
            atol=atol, rtol=1e-5,
            err_msg=f"{name} differs between single-device and {n}-way sharded render",
        )


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_pallas_display_matches_single_device(n):
    """The hard Pallas kernel's band hook (hard_band_packed): the sharded
    display path must reproduce the single-device Pallas render exactly
    (same kernel math per band, only the row origin differs)."""
    from rtwc_tpu.render.pallas_kernel import render_frame_pallas

    mesh = make_mesh(n)
    scene, cam = default_scene(CFG), default_camera()
    fb_single = render_frame_pallas(scene, cam, CFG, interpret=True)
    fb_sharded = render_frame_sharded(scene, cam, CFG, mesh, interpret=True)
    for name in ("rgb", "normal", "depth", "shading"):
        np.testing.assert_allclose(
            np.asarray(getattr(fb_single, name)),
            np.asarray(getattr(fb_sharded, name)),
            atol=1e-5, rtol=1e-6,
            err_msg=f"{name} differs between single-device and {n}-way "
                    f"sharded pallas render",
        )


def test_sharded_render_rejects_bad_height():
    mesh = make_mesh(8)
    cfg = CFG.replace(height=30)  # not divisible by 8
    with pytest.raises(ValueError):
        render_frame_sharded(default_scene(cfg), default_camera(), cfg, mesh)


def test_sharded_train_step_decreases_loss():
    import optax

    mesh = make_mesh(8)
    cfg = CFG
    target_scene = default_scene(cfg)
    cam = default_camera()
    # Smooth optimization regime (moderate tau + penalty) - the sharp
    # display config has sub-pixel silhouette bands with no usable grads.
    # The target is rendered with the SAME soft model the train step uses,
    # so the true scene is the exact global minimum (well-posed inverse
    # problem; a tau-mismatched target has a flat noisy landscape instead).
    tcfg = cfg.replace(soft_miss_penalty=300.0, soft_mask_k=10.0)
    target = render_frame_soft(target_scene, cam, tcfg, tau=0.5).rgb

    # Perturb sphere centers; the step must pull them back. Only the
    # centers are trainable (optax.masked) - exactly the inverse-render
    # setup of BASELINE config 3.
    bad = target_scene.replace(
        spheres=target_scene.spheres.replace(
            center=target_scene.spheres.center + 0.5
        )
    )

    def labels(params):
        scene, camera = params
        slab = jax.tree.map(lambda _: "freeze", scene)
        clab = jax.tree.map(lambda _: "freeze", camera)
        return (slab.replace(spheres=slab.spheres.replace(center="train")), clab)

    # multi_transform, not optax.masked: masked() passes non-masked leaves'
    # updates (raw grads) through unchanged, which would ascend everything.
    opt = optax.multi_transform(
        {"train": optax.adam(5e-2), "freeze": optax.set_to_zero()}, labels
    )
    step = make_sharded_train_step(tcfg, mesh, tau=0.5, optimizer=opt)
    params = (bad, cam)
    opt_state = step.init(params)

    params, opt_state, loss0 = step(params, opt_state, target)
    losses = []
    for _ in range(30):
        params, opt_state, loss = step(params, opt_state, target)
        losses.append(float(loss))
    assert min(losses[-5:]) < float(loss0), (float(loss0), losses)


def test_sharded_pallas_backend_matches_jnp():
    """The pallas-kernel train step computes the same loss and gradients as
    the jnp train step on the simulated mesh (BASELINE configs 4-5 with the
    fused fwd+bwd kernels)."""
    import optax

    mesh = make_mesh(4)
    cfg = CFG.replace(soft_miss_penalty=300.0, soft_mask_k=10.0)
    scene, cam = default_scene(cfg), default_camera()
    target = render_frame_soft(scene, cam, cfg, tau=0.5).rgb + 10.0

    def one_sgd_step(kernel):
        step = make_sharded_train_step(cfg, mesh, tau=0.5,
                                       optimizer=optax.sgd(1.0),
                                       interpret=kernel)
        params = (scene, cam)
        (new_scene, _), _, loss = step(params, step.init(params), target)
        grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                             scene, new_scene)
        return float(loss), grads

    loss_j, g_j = one_sgd_step(False)
    loss_p, g_p = one_sgd_step(True)
    assert abs(loss_j - loss_p) < 1e-6 * max(1.0, abs(loss_j))
    np.testing.assert_allclose(g_p.spheres.center, g_j.spheres.center,
                               rtol=2e-2, atol=1e-7)
    np.testing.assert_allclose(g_p.spheres.color, g_j.spheres.color,
                               rtol=2e-2, atol=1e-9)


def test_sharded_pallas_backend_matches_jnp_shadowed():
    """Same as above with the differentiable shadow term on: the shadow
    visibility is evaluated at each ray's blended hit point, so a band
    renders it locally without cross-band exchange - occluder gradients
    must still pmean to the single-program values."""
    import optax

    mesh = make_mesh(4)
    cfg = CFG.replace(soft_miss_penalty=300.0, soft_mask_k=10.0, shadows=True)
    scene, cam = default_scene(cfg), default_camera()
    target = render_frame_soft(scene, cam, cfg, tau=0.5).rgb + 10.0

    def one_sgd_step(kernel):
        step = make_sharded_train_step(cfg, mesh, tau=0.5,
                                       optimizer=optax.sgd(1.0),
                                       interpret=kernel)
        params = (scene, cam)
        (new_scene, _), _, loss = step(params, step.init(params), target)
        grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                             scene, new_scene)
        return float(loss), grads

    loss_j, g_j = one_sgd_step(False)
    loss_p, g_p = one_sgd_step(True)
    assert abs(loss_j - loss_p) < 1e-6 * max(1.0, abs(loss_j))
    np.testing.assert_allclose(g_p.spheres.center, g_j.spheres.center,
                               rtol=2e-2, atol=1e-6)
    np.testing.assert_allclose(g_p.spheres.color, g_j.spheres.color,
                               rtol=2e-2, atol=1e-9)


def test_sharded_train_step_animated():
    """BASELINE config 4: the sharded train step with the physics tick
    (update_scene) applied inside the step. The animated step must (a) run
    and return finite loss, (b) equal the unanimated step at dt=0, and
    (c) at dt>0 equal rendering the pre-ticked scene."""
    import optax

    from rtwc_tpu.scene import update_scene

    mesh = make_mesh(4)
    cfg = CFG.replace(soft_miss_penalty=300.0, soft_mask_k=10.0)
    scene, cam = default_scene(cfg), default_camera()
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    opt = optax.sgd(0.0)  # loss probe only

    step_anim = make_sharded_train_step(cfg, mesh, tau=0.5, optimizer=opt,
                                        animate=True)
    step_plain = make_sharded_train_step(cfg, mesh, tau=0.5, optimizer=opt)
    params = (scene, cam)
    st = step_anim.init(params)

    _, _, loss_dt0 = step_anim(params, st, target, 0.0)
    _, _, loss_plain = step_plain(params, st, target)
    assert np.isfinite(float(loss_dt0))
    np.testing.assert_allclose(float(loss_dt0), float(loss_plain), rtol=1e-6)

    dt = 0.25
    _, _, loss_anim = step_anim(params, st, target, dt)
    ticked = update_scene(scene, jnp.float32(dt), cfg.bob_min_y, cfg.bob_max_y)
    _, _, loss_ticked = step_plain((ticked, cam), st, target)
    np.testing.assert_allclose(float(loss_anim), float(loss_ticked), rtol=1e-6)
    assert abs(float(loss_anim) - float(loss_dt0)) > 0  # the tick moved spheres


def test_sharded_grads_match_single_device():
    import functools

    mesh = make_mesh(4)
    cfg = CFG
    scene, cam = default_scene(cfg), default_camera()
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)

    def single_loss(scene):
        rgb = render_frame_soft(scene, cam, cfg, tau=0.05).rgb
        return jnp.mean(((rgb - target) / 255.0) ** 2)

    g_single = jax.grad(single_loss)(scene)

    # Sharded gradient via the train-step internals: one step of SGD with
    # lr so updates equal -grads, then diff params.
    import optax

    step = make_sharded_train_step(cfg, mesh, tau=0.05, optimizer=optax.sgd(1.0))
    params = (scene, cam)
    opt_state = step.init(params)
    (new_scene, _), _, _ = step(params, opt_state, target)
    g_sharded = jax.tree.map(lambda a, b: a - b, scene, new_scene)

    np.testing.assert_allclose(
        np.asarray(g_sharded.spheres.center),
        np.asarray(g_single.spheres.center),
        rtol=5e-2, atol=2e-6,  # f32, different XLA programs + pmean order
    )


def test_gradient_allreduce_is_single_fused_collective():
    """Schedule evidence for the BASELINE overlap north star: the sharded
    train step's gradient reduction compiles to exactly ONE step-level
    cross-device all-reduce that carries every gradient leaf of the
    (scene, camera) pytree at once - not one collective per leaf, and
    with nothing left outside the collective. With the one-pass fused
    kernel all leaves materialize at kernel end, so a single fused
    KB-scale collective is the schedule to keep; this test pins that
    structure on the 8-virtual-device mesh so a regression to per-leaf
    collectives is caught."""
    cfg = RenderConfig(width=256, height=64, max_spheres=8, max_planes=2,
                       shadows=True, soft_miss_penalty=300.0,
                       soft_mask_k=10.0)
    mesh = make_mesh(8)
    step = make_sharded_train_step(cfg, mesh, tau=0.5, interpret=True)
    scene = default_scene(cfg)
    params = (scene, default_camera())
    opt_state = step.init(params)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    txt = jax.jit(step).lower(params, opt_state, target).compile().as_text()
    n_sync = txt.count(" all-reduce(")
    n_async = txt.count(" all-reduce-start(")
    assert n_sync + n_async == 1, (
        f"expected ONE fused gradient all-reduce, found {n_sync} sync + "
        f"{n_async} async")
    # The collective must carry the full gradient pytree: count its f32
    # operand leaves (scene tables + camera pos/rot + loss = >= 10).
    line = next(l for l in txt.splitlines()
                if " all-reduce(" in l or " all-reduce-start(" in l)
    head = line.rsplit(" all-reduce", 1)[0]   # the result-shape tuple
    assert head.count("f32[") >= 10, line[:200]
