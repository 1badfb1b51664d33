"""Differentiable renderer: soft-min hit blending.

New capability over the reference (BASELINE north star): the reference's
hit logic is branch-heavy (Sphere.cu:42-60, Plane.cu:47-68, closest-hit
select RayTracing.cu:123-135) and therefore piecewise-constant in which
object wins - gradients w.r.t. geometry/camera vanish at silhouettes.

Design: every hard reject branch becomes a smooth *depth penalty*. A
violated constraint (negative discriminant, root behind the camera,
backface, outside the rectangle extent) pushes the object's effective
depth past the far plane:

    t_eff = clip(t, 0, far) + miss_penalty * sum_c softplus(-k * x_c) / k

where x_c > 0 means constraint c is satisfied. The closest-hit argmin then
becomes a temperature-tau softmin over {objects, background-at-far} of
t_eff. Because penalties live in depth units, they compete with the
background on the same 1/tau scale: as tau -> 0 the soft forward converges
to the hard reference image with a silhouette halo of width
~ far / miss_penalty (sub-pixel for the default penalty), and
d(pixel)/d(centers, radii, normals, extents, colors, camera pose) exists
everywhere and is finite-difference consistent.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from rtwc_tpu.camera import Camera, camera_rays, projection_elements
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.mathx import dot, safe_normalize
from rtwc_tpu.render.reference import (
    Framebuffer,
    blinn_phong,
    render_frame,
    _FLT_EPSILON,
)
from rtwc_tpu.scene import Scene

_INACTIVE_PENALTY = 1e7  # depth units; removes dead pool slots outright
_TRANS_FLOOR = 1e-7  # per-occluder shadow transmittance floor (see below)


def _penalty(x: jax.Array, k: float) -> jax.Array:
    """Smooth hinge: ~|x| for x < 0, ~0 for x > 0, ln(2)/k at x = 0."""
    return jax.nn.softplus(-k * x) / k


def perp_discriminant(oc, dirs, half_b, radius):
    """b^2 - 4c of the unit-direction ray/sphere quadratic (b = 2 d.oc,
    c = |oc|^2 - r^2) in its perpendicular form 4 (r^2 - |oc - (d.oc) d|^2).
    The textbook form cancels two terms of size |oc|^2 at grazing rays,
    so its rounding error scales with the squared distance; here it
    scales with distance times radius. Softmin weights at silhouettes
    hang on this value, so two float32 programs that round it
    differently would disagree there by a few per cent."""
    perp = oc - half_b[..., None] * dirs
    return 4.0 * (radius**2 - jnp.sum(perp * perp, axis=-1))


def _soft_sphere_terms(origin, dirs, spheres, k: float, miss_penalty: float, far: float):
    """Soft sphere intersection (Sphere.cu:30-68 semantics): returns
    (t_eff [..,N], t_clip [..,N], normal [..,N,3])."""
    oc = origin - spheres.center                        # [N, 3]
    half_b = jnp.einsum("...k,nk->...n", dirs, oc, precision=jax.lax.Precision.HIGHEST)  # [..., N]
    b = 2.0 * half_b
    disc = perp_discriminant(oc, dirs[..., None, :], half_b, spheres.radius)
    sq = jnp.sqrt(jnp.maximum(disc, 1e-12))
    t1 = 0.5 * (-b + sq)
    t2 = 0.5 * (-b - sq)
    # Normalize the discriminant by the sphere scale so the penalty width
    # is size-independent (disc carries units of length^2). The hard test
    # requires t1 >= 0 AND t2 >= 0 (Sphere.cu:55-60), but t1 = t2 + sqrt(disc)
    # >= t2, so penalizing t2 alone covers both conditions exactly.
    scale = 1.0 / jnp.maximum(spheres.radius, 1e-3)
    pen = miss_penalty * (
        _penalty(disc * scale * scale, k) + _penalty(t2, k)
    ) + jnp.where(spheres.active > 0.5, 0.0, _INACTIVE_PENALTY)
    t_clip = jnp.clip(t2, 0.0, far)
    p = origin + dirs[..., None, :] * t_clip[..., None]
    n = safe_normalize(p - spheres.center)
    return t_clip + pen, t_clip, n


def _soft_plane_terms(origin, dirs, planes, k: float, miss_penalty: float, far: float):
    """Soft finite-plane intersection (Plane.cu:38-73 semantics)."""
    denom = jnp.einsum("...k,mk->...m", dirs, planes.normal, precision=jax.lax.Precision.HIGHEST)
    po = planes.center - origin
    num = dot(po, planes.normal)
    safe_denom = jnp.where(jnp.abs(denom) < _FLT_EPSILON, -_FLT_EPSILON, denom)
    t = num / safe_denom
    t_clip = jnp.clip(t, 0.0, far)
    p = origin + dirs[..., None, :] * t_clip[..., None]
    half_w = planes.width * 0.5
    half_h = planes.height * 0.5
    pen = miss_penalty * (
        _penalty(-denom - _FLT_EPSILON, k)
        + _penalty(t, k)
        + _penalty(half_w - jnp.abs(p[..., 0] - planes.center[:, 0]), k)
        + _penalty(half_h - jnp.abs(p[..., 2] - planes.center[:, 2]), k)
    ) + jnp.where(planes.active > 0.5, 0.0, _INACTIVE_PENALTY)
    n = jnp.broadcast_to(planes.normal, p.shape)
    return t_clip + pen, t_clip, n


def _soft_shadow_visibility(scene: Scene, point, config: RenderConfig):
    """Differentiable shadow term (soft analogue of reference.py's
    _shadow_visibility): every hard shadow-ray reject branch becomes a
    sigmoid step of sharpness soft_shadow_k, and the any-occluder OR
    becomes a product of per-occluder transmittances

        vis = prod_j (1 - block_j),
        block_j = prod_c sigmoid(k * x_c)   (x_c > 0 <=> condition c holds)

    evaluated once per ray at the blended hit point. As k -> inf this
    converges to the hard test; gradients flow to occluder geometry and
    (through the blended point) to the receiving surface and camera.
    """
    ks = config.soft_shadow_k
    sig = jax.nn.sigmoid
    light_pos = jnp.asarray(config.light_pos, jnp.float32)
    to_light = light_pos - point
    dist = jnp.sqrt(jnp.maximum(dot(to_light, to_light), 1e-12))
    d = to_light / dist[..., None]
    o = point + d * 1e-2  # self-intersection offset (reference uses 1e-3)

    sp = scene.spheres
    oc = o[..., None, :] - sp.center                                 # [..., N, 3]
    half_b = jnp.sum(d[..., None, :] * oc, axis=-1)
    b = 2.0 * half_b
    disc = perp_discriminant(oc, d[..., None, :], half_b, sp.radius)
    sq = jnp.sqrt(jnp.maximum(disc, 1e-12))
    t1 = 0.5 * (-b + sq)
    t2 = 0.5 * (-b - sq)
    scale = 1.0 / jnp.maximum(sp.radius, 1e-3)
    block_s = (
        sig(ks * disc * scale * scale)
        * sig(ks * t1) * sig(ks * t2)
        * sig(ks * (dist[..., None] - t2))
        * jnp.where(sp.active > 0.5, 1.0, 0.0)
    )

    pl = scene.planes
    denom = jnp.sum(d[..., None, :] * pl.normal, axis=-1)            # [..., M]
    num = jnp.sum((pl.center - o[..., None, :]) * pl.normal, axis=-1)
    safe_denom = jnp.where(jnp.abs(denom) < _FLT_EPSILON, -_FLT_EPSILON, denom)
    t = num / safe_denom
    p = o[..., None, :] + d[..., None, :] * t[..., None]
    block_p = (
        sig(ks * (-denom - _FLT_EPSILON))
        * sig(ks * t)
        * sig(ks * (pl.width * 0.5 - jnp.abs(p[..., 0] - pl.center[:, 0])))
        * sig(ks * (pl.height * 0.5 - jnp.abs(p[..., 2] - pl.center[:, 2])))
        * sig(ks * (dist[..., None] - t))
        * jnp.where(pl.active > 0.5, 1.0, 0.0)
    )

    trans = jnp.concatenate([1.0 - block_s, 1.0 - block_p], axis=-1)
    # Transmittance floor: a fully saturated sigmoid product hits exactly
    # 1.0f and would make the per-occluder product gradient 0/0 in the
    # fused kernel's closed-form (vis / trans_j) replay. Flooring at 1e-7
    # changes vis by < 1e-7 per occluder (invisible at 0..255 color scale)
    # and keeps the jnp path and render/pallas_soft.py bit-comparable.
    trans = jnp.maximum(trans, _TRANS_FLOOR)
    return jnp.prod(trans, axis=-1)


def trace_soft(scene: Scene, origin, dirs, config: RenderConfig, tau: float | None = None):
    """Soft closest-hit + shading blend.

    Returns (rgb [..,3] 0..255, depth [..,], normal [..,3], alpha [..,])
    where alpha = soft hit probability (1 - background weight) and depth
    blends to `far` for misses.
    """
    tau = config.soft_tau if tau is None else tau
    if tau <= 0.0:
        raise ValueError("trace_soft needs tau > 0; tau == 0 means the hard renderer (render_frame)")
    k = config.soft_mask_k
    mp = config.soft_miss_penalty
    te_s, tc_s, ns = _soft_sphere_terms(origin, dirs, scene.spheres, k, mp, config.far)
    te_p, tc_p, np_ = _soft_plane_terms(origin, dirs, scene.planes, k, mp, config.far)

    t_eff = jnp.concatenate([te_s, te_p], axis=-1)                   # [..., O]
    t_clip = jnp.concatenate([tc_s, tc_p], axis=-1)                  # [..., O]
    n_all = jnp.concatenate([ns, np_], axis=-2)                      # [..., O, 3]
    color_all = jnp.concatenate([scene.spheres.color, scene.planes.color], axis=0)

    logits = -t_eff / tau                                            # [..., O]
    bg_logit = jnp.full(logits.shape[:-1], -config.far / tau)
    all_logits = jnp.concatenate([logits, bg_logit[..., None]], axis=-1)
    w = jax.nn.softmax(all_logits, axis=-1)                          # [..., O+1]
    w_obj, w_bg = w[..., :-1], w[..., -1]

    # Per-object shading at each object's own clipped hit point (blending
    # already-shaded colors keeps silhouette gradients clean).
    point = origin + dirs[..., None, :] * t_clip[..., None]          # [..., O, 3]
    view = safe_normalize(-dirs)[..., None, :]
    if config.shadows:
        # Differentiable shadows: one soft occlusion test per ray at the
        # softmin-blended hit point (O(rays x objects), not per-object
        # points which would square the object cost); the visibility
        # scales every object's direct light, ambient survives.
        depth_blend = jnp.sum(w_obj * t_clip, axis=-1) + w_bg * config.far
        point_blend = origin + dirs * depth_blend[..., None]
        vis = _soft_shadow_visibility(scene, point_blend, config)[..., None]
    else:
        vis = None
    shaded = blinn_phong(color_all / 255.0,
                         jnp.asarray(config.object_specular_color, jnp.float32),
                         point, view, n_all, config,
                         light_visibility=vis)
    rgb_obj = jnp.minimum(255.0, shaded * 255.0)                     # [..., O, 3]

    rgb = jnp.sum(w_obj[..., None] * rgb_obj, axis=-2)               # bg adds 0
    depth = jnp.sum(w_obj * t_clip, axis=-1) + w_bg * config.far
    normal = jnp.sum(w_obj[..., None] * n_all, axis=-2)
    alpha = 1.0 - w_bg
    return rgb, depth, normal, alpha


def render_frame_soft(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    tau: float | None = None,
    straight_through: bool = False,
) -> Framebuffer:
    """Differentiable frame render. With straight_through=True the forward
    pass is the exact hard reference image while gradients flow through the
    soft path (hard + stop_grad composition)."""
    e1, e2 = projection_elements(config)
    origin, dirs = camera_rays(camera, config.width, config.height, e1, e2)
    rgb, depth, normal, alpha = trace_soft(scene, origin, dirs, config, tau=tau)
    if straight_through:
        # hard + (soft - stop_grad(soft)): forward equals the hard image
        # bit-exactly (the soft terms cancel), backward flows through soft.
        hard = render_frame(scene, camera, config)
        rgb = hard.rgb + (rgb - jax.lax.stop_gradient(rgb))
        depth = jnp.minimum(hard.depth, config.far) + (depth - jax.lax.stop_gradient(depth))
        normal = hard.normal + (normal - jax.lax.stop_gradient(normal))
    hit = depth <= config.far * (1.0 - 1e-4)
    return Framebuffer(rgb=rgb, normal=normal, depth=depth, shading=normal[..., 0], hit=hit,
                       coverage=hit.astype(jnp.float32), alpha=alpha)


# Per-sub-band cap on band_mse_loss's [rows, W, n_obj, 3] shading
# intermediates.
_CHUNK_BYTES = 128 * 2**20


def band_mse_loss(scene: Scene, camera: Camera, target_band, config: RenderConfig,
                  tau: float, row0=0) -> jax.Array:
    """mean(((rgb - target_band)/255)^2) of the soft render over a band of
    target_band.shape[0] image rows starting at (traced) row0: the jnp
    reference of the fused MSE kernel (render/pallas_soft.py).

    The rows are cut into sub-bands so the [r, W, n_obj, 3] shading
    intermediates stay bounded (4K with 200 spheres would otherwise
    materialize hundreds of GB), and each sub-band is jax.checkpoint'ed so
    reverse-mode stores only its inputs and recomputes the forward."""
    rows = target_band.shape[0]
    e1, e2 = projection_elements(config)
    n_obj = scene.spheres.capacity + scene.planes.center.shape[0]
    bytes_per_row = config.width * n_obj * 3 * 4
    sub = max(1, min(rows, _CHUNK_BYTES // max(1, bytes_per_row)))
    while rows % sub:
        sub -= 1

    def sub_band(r0):
        origin, dirs = camera_rays(camera, config.width, config.height, e1, e2,
                                   row_start=r0, n_rows=sub)
        return trace_soft(scene, origin, dirs, config, tau=tau)[0]

    if sub == rows:
        rgb = sub_band(row0)
    else:
        r0s = row0 + jnp.arange(rows // sub) * sub
        rgb = jax.lax.map(jax.checkpoint(sub_band), r0s).reshape(
            rows, config.width, 3)
    err = (rgb - target_band) / 255.0
    return jnp.mean(err * err)
