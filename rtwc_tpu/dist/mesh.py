"""Device-mesh sharding of the renderer.

The reference is single-process / single-GPU: its only notion of scale is
the 2-D CUDA launch grid over pixels (RayTracingManager.cu:120-134). Here
the same axis is lifted across devices (SURVEY.md section 5, BASELINE
configs 4-5): shard the ray/tile dimension (image rows) over a 1-D mesh,
replicate the tiny scene (<= a few hundred objects x 32 B), and pmean the
scene-parameter gradients across devices after the backward pass. The
cards of one host are joined all to all (NVLink), so the mesh follows the
algorithm alone: one axis of row bands. With the one-pass fused kernel
every gradient leaf exists only at kernel end, so the gradient reduction
is one step-level all-reduce of a KB-scale payload (tests/test_dist.py
pins that structure).

Everything mesh-related lives in this one module so the rest of the
framework stays mesh-agnostic (SURVEY.md section 5 design note).
"""
from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rtwc_tpu.camera import Camera, camera_rays, projection_elements
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.render.reference import Framebuffer, shade, trace_hard
from rtwc_tpu.render.backend import use_kernels
from rtwc_tpu.render.softmin import band_mse_loss
from rtwc_tpu.scene import Scene

TILE_AXIS = "tiles"


def make_mesh(n_devices: int | None = None, axis_name: str = TILE_AXIS) -> Mesh:
    """1-D mesh over all (or the first n) addressable devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def _check_divisible(height: int, n: int) -> int:
    if height % n:
        raise ValueError(
            f"height {height} must divide by mesh size {n} for tile sharding "
            f"(pad the image or change the mesh)"
        )
    return height // n


@functools.lru_cache(maxsize=32)
def _make_render_sharded(config: RenderConfig, mesh: Mesh, interpret: bool):
    n = mesh.shape[TILE_AXIS]
    rows_per = _check_divisible(config.height, n)
    e1, e2 = projection_elements(config)
    kernel = interpret or use_kernels()

    def band(scene: Scene, camera: Camera) -> Framebuffer:
        tile = jax.lax.axis_index(TILE_AXIS)
        row0 = tile * rows_per
        if kernel:
            # Fused hard kernel (render/pallas_kernel.py) with the band
            # hook: the display path scales across the mesh at kernel
            # speed, not jnp speed.
            from rtwc_tpu.render import pack as _pack
            from rtwc_tpu.render.pallas_kernel import (
                hard_band_packed, planes_to_framebuffer,
            )

            sph, pl_, counts = _pack.pack_scene(scene)
            cam = _pack.pack_camera(camera)
            out = hard_band_packed(sph, pl_, counts.reshape(1, 2), cam, row0,
                                   config=config, band_h=rows_per,
                                   interpret=interpret)
            return planes_to_framebuffer(out, config, rows_per)
        origin, dirs = camera_rays(
            camera, config.width, config.height, e1, e2, row_start=row0, n_rows=rows_per
        )
        t, normal, color, shading = trace_hard(scene, origin, dirs)
        rgb = shade(scene, origin, dirs, t, normal, color, config)
        hit = t <= config.far
        return Framebuffer(rgb=rgb, normal=normal, depth=t, shading=shading, hit=hit,
                           coverage=hit.astype(jnp.float32),
                           alpha=hit.astype(jnp.float32))

    fn = shard_map(
        band,
        mesh=mesh,
        in_specs=(P(), P()),            # scene + camera replicated
        out_specs=jax.tree.map(lambda _: P(TILE_AXIS), Framebuffer(0, 0, 0, 0, 0, 0, 0)),
        # pallas_call can't annotate varying-mesh-axes on its out_shape yet.
        check_vma=False,
    )
    return jax.jit(fn)


def render_frame_sharded(
    scene: Scene, camera: Camera, config: RenderConfig, mesh: Mesh,
    interpret: bool = False,
) -> Framebuffer:
    """Tile-sharded forward render: each device renders its band of image
    rows against the replicated scene. Output framebuffer leaves are
    sharded over rows; per-pixel values match the single-device render to
    the last bits (validated in tests/test_dist.py). Each band runs the
    fused hard kernel on the GPU and the jnp renderer on the CPU
    (render/backend.py); interpret=True runs the kernel in the Pallas
    interpreter (CPU tests). The jitted program is cached per (config,
    mesh, interpret)."""
    return _make_render_sharded(config, mesh, interpret)(scene, camera)


def make_sharded_train_step(
    config: RenderConfig,
    mesh: Mesh,
    tau: float,
    optimizer=None,
    loss_scale: float = 1.0 / 255.0,
    animate: bool = False,
    interpret: bool = False,
) -> Callable:
    """Build the jitted multi-chip inverse-rendering train step
    (BASELINE configs 4-5; the train_step analogue of Engine3D::Run).

    Each device: renders its row band with the soft differentiable renderer,
    computes the local MSE against its shard of the target image, and
    back-propagates to the *replicated* scene + camera parameters; gradients
    are pmean-reduced over the mesh in one fused step-level all-reduce
    after the backward kernel (see module docstring). Returns
    step(params, opt_state, target, dt=0.0) -> (params, opt_state, loss).
    params = (scene, camera). The loss is
    mean(((rgb - target) * loss_scale)^2).

    animate=True ticks the sphere physics (scene.update_scene: the bob
    kernel of RayTracingManager.cu:10-44 / Sphere.cu:15-23) by the traced
    `dt` argument inside the step, before rendering - BASELINE config 4's
    "animated scene" in the sharded train loop. The tick is replicated
    (objects are tiny) and differentiable, so gradients flow through it to
    the base scene parameters.

    Each band runs the one-pass fused MSE kernel (render/pallas_soft.py)
    on the GPU and the jnp soft renderer on the CPU (render/backend.py);
    interpret=True runs the kernel in the Pallas interpreter (CPU tests).
    """
    import optax

    if optimizer is None:
        optimizer = optax.adam(1e-2)

    n = mesh.shape[TILE_AXIS]
    rows_per = _check_divisible(config.height, n)
    kernel = interpret or use_kernels()
    # Both renderers compute mean(((rgb - t)/255)^2); other scales are a
    # constant factor.
    scale2 = (loss_scale * 255.0) ** 2

    def local_loss(params, target_band, dt):
        scene, camera = params
        if animate:
            from rtwc_tpu.scene import update_scene

            scene = update_scene(scene, dt, config.bob_min_y, config.bob_max_y)
        tile = jax.lax.axis_index(TILE_AXIS)
        row0 = tile * rows_per
        if kernel:
            # One-pass fused MSE kernel on this device's band, from packed
            # tables; its custom VJP returns table grads that chain
            # through pack_scene/pack_camera here.
            from rtwc_tpu.render import pack as _pack
            from rtwc_tpu.render.pallas_soft import soft_band_mse_loss

            sph, pl_, counts = _pack.pack_scene(scene)
            loss = soft_band_mse_loss(sph, pl_, counts,
                                      _pack.pack_camera(camera), row0,
                                      target_band, config=config, tau=tau,
                                      band_h=rows_per, interpret=interpret)
        else:
            loss = band_mse_loss(scene, camera, target_band, config, tau, row0)
        return loss * scale2

    def shard_step(params, target_band, dt):
        loss, grads = jax.value_and_grad(local_loss)(params, target_band, dt)
        # Replicated params -> gradients must be averaged across the mesh.
        grads = jax.lax.pmean(grads, TILE_AXIS)
        loss = jax.lax.pmean(loss, TILE_AXIS)
        return loss, grads

    sharded_grads = shard_map(
        shard_step,
        mesh=mesh,
        in_specs=(P(), P(TILE_AXIS), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(params, opt_state, target, dt=0.0):
        loss, grads = sharded_grads(params, target, jnp.asarray(dt, jnp.float32))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def init(params):
        return optimizer.init(params)

    step.init = init
    return step
