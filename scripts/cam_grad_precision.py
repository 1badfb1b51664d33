"""Where the float32 camera-rotation gradient error comes from, measured.

This study (CPU, f32 vs f64 reruns of the jnp soft renderer at 640x360,
20 spheres, shadows) separates summation error from per-ray error:

  1. The per-basis-element and per-rotation-DOF plane sums are
     well-conditioned (sum|contrib| / |total| ~ 5-10): any reasonable
     f32 reduction carries < 1e-5 relative summation error. (The fused
     kernel reduces with an error-free two-float tree anyway -
     pallas_soft._twofloat_plane_sum, exact to double-float precision
     per tests/test_pallas_soft.py::test_twofloat_plane_sum.)
  2. The error lives in the PER-RAY f32 cotangents of a small population
     of silhouette rays, where the softmin weight hangs on the sphere
     discriminant. With the textbook discriminant b^2 - 4c (two terms of
     size |oc|^2 cancel at grazing rays) the exact f64 sum of the f32
     per-ray contributions landed 18% from the f64 truth; with the
     perpendicular form (softmin.perp_discriminant) it lands 2.5% away
     (per-ray max error 2.9e-3 against 2.2e-2 before). Each f32 program
     computes the correct gradient OF ITS OWN f32 loss; two programs that
     round silhouette rays differently scatter by about this much.

Run on CPU (f64 needs it): PYTHONPATH= JAX_PLATFORMS=cpu python
scripts/cam_grad_precision.py. Prints one JSON line with the measured
conditions, the exact-sum-of-f32-inputs error, and the per-ray error
distribution.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np


def per_ray_rot_contribs(x64: bool):
    """[H, W, 9] per-ray basis-element cotangent contributions and the
    9x3 basis->rot jacobian, at the parity-check scene, in f32 or f64."""
    jax.config.update("jax_enable_x64", x64)
    for m in list(sys.modules):
        if m.startswith("rtwc_tpu"):
            del sys.modules[m]
    import jax.numpy as jnp
    from rtwc_tpu.camera import Camera, default_camera, basis, projection_elements
    from rtwc_tpu.config import RenderConfig
    from rtwc_tpu.render.softmin import trace_soft
    from rtwc_tpu.scene import random_scene

    dt = jnp.float64 if x64 else jnp.float32
    cfg = RenderConfig(width=640, height=360, max_spheres=24, max_planes=4,
                       soft_miss_penalty=300.0, soft_mask_k=10.0, shadows=True)
    scene = jax.tree.map(
        lambda x: jnp.asarray(x, dt) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        random_scene(20, max_spheres=24, max_planes=4, seed=0))
    cam = Camera(pos=jnp.asarray(default_camera().pos, dt),
                 rot=jnp.asarray(default_camera().rot, dt))
    e1, e2 = projection_elements(cfg)
    H, W = cfg.height, cfg.width
    target = jnp.zeros((H, W, 3), dt)

    def loss_of_d(d, pos):
        rgb, depth, _, _ = trace_soft(scene, pos, d, cfg, tau=0.5)
        return (jnp.mean(((rgb - target) / 255.0) ** 2)
                + 0.01 * jnp.mean(depth) / cfg.far)

    r, u, f = basis(cam.rot)
    rows = jnp.arange(H, dtype=dt)
    cols = jnp.arange(W, dtype=dt)
    vx = (2.0 * cols - W) / W * e1
    vy = (H - 2.0 * rows) / H * e2
    p = vx[None, :, None] * r + vy[:, None, None] * u + f
    d = p / jnp.linalg.norm(p, axis=-1, keepdims=True)
    gd = jax.jit(jax.grad(loss_of_d))(d, cam.pos)
    nrm = jnp.linalg.norm(p, axis=-1, keepdims=True)
    S = jnp.sum(gd * d, -1, keepdims=True)
    gp = (gd - d * S) / nrm
    # p = vx*r + vy*u + f  =>  dL/dr = sum gp*vx, dL/du = sum gp*vy, dL/df = sum gp
    contribB = jnp.concatenate(
        [gp * vx[None, :, None], gp * vy[:, None, None], gp], axis=-1)
    dB = jax.jacobian(lambda rot: jnp.concatenate(list(basis(rot))))(
        jnp.asarray(np.asarray(cam.rot, np.float64)))
    return np.asarray(contribB, np.float64), np.asarray(dB, np.float64)


def main() -> None:
    if jax.default_backend() != "cpu":
        sys.exit("run on CPU (needs f64): PYTHONPATH= JAX_PLATFORMS=cpu ...")
    c32, dB = per_ray_rot_contribs(False)
    c64, _ = per_ray_rot_contribs(True)

    rotc32 = np.einsum("hwa,ak->hwk", c32, dB)
    rotc64 = np.einsum("hwa,ak->hwk", c64, dB)
    tot32 = rotc32.sum((0, 1))     # EXACT f64 sum of the f32 per-ray inputs
    tot64 = rotc64.sum((0, 1))
    scale = np.abs(tot64).max()
    cond = np.abs(rotc64).sum((0, 1))[:2] / np.abs(tot64[:2])
    err = np.abs(rotc32 - rotc64).max(-1)
    out = {
        "rot_grad_f64": tot64.round(8).tolist(),
        "rot_grad_exact_sum_of_f32_inputs": tot32.round(8).tolist(),
        "rel_err_exact_summation": float(np.abs(tot32 - tot64).max() / scale),
        "sum_condition_numbers": cond.round(1).tolist(),
        "per_ray_err_mean": float(err.mean()),
        "per_ray_err_p999": float(np.percentile(err, 99.9)),
        "per_ray_err_max": float(err.max()),
        "verdict": "per-ray f32 cotangent divergence at silhouettes, not "
                   "summation order, sets the floor",
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
