"""Fit an occluder you cannot see, from the shadow it casts.

The occluding sphere sits far above the camera frustum: no primary ray
ever hits it, so the unshadowed image is bit-identical with or without it
(the script asserts this). The only evidence of its existence is the soft
shadow it throws on the ground plane - and because the soft renderer
(render/softmin.py) differentiates *through the shadow
term*, gradient descent on the image loss recovers its position anyway.

This is strictly impossible in the reference renderer (CUDA,
RayTracing.cu): it has no shadows and no gradients.

A single point light makes the occluder's position along the light ray
nearly unobservable (sliding it toward the light leaves the umbra's
position fixed and only softens the penumbra), so the demo fits the
well-posed coordinates - horizontal position at a known height - and
reports the residual. The gradient signal itself is full 3-D.

Usage:
    python examples/fit_from_shadow.py [--steps 300] [--width 320] [--height 96]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from rtwc_tpu.camera import Camera, default_camera
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.render import render_frame_soft
from rtwc_tpu.utils.compile_cache import enable_compile_cache
from rtwc_tpu.scene import add_plane, add_sphere, empty_scene

TRUE_OCCLUDER = (2.0, 26.0, 20.0)  # between the light (1, 50, 0) and the floor


def build(width: int, height: int):
    cfg = RenderConfig(width=width, height=height, max_spheres=2, max_planes=1,
                       soft_miss_penalty=300.0, soft_mask_k=10.0,
                       shadows=True)
    s = empty_scene(cfg.max_spheres, cfg.max_planes)
    # the stage: a floor and one visible sphere for context
    s = add_plane(s, (0.0, -4.0, 40.0), (0.0, 1.0, 0.0), (120.0, 120.0, 120.0), 120.0, 120.0)
    s = add_sphere(s, 4.0, (-8.0, 0.0, 45.0), (220.0, 60.0, 60.0), speed=1.0)
    # the hidden occluder, far above the frustum
    s = add_sphere(s, 4.0, TRUE_OCCLUDER, (60.0, 60.0, 220.0), speed=1.0)
    return cfg, s


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--tau", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=1e-1)
    p.add_argument("--offset", type=float, nargs=2, default=(3.0, 4.0),
                   help="initial occluder (x, z) displacement from the truth")
    args = p.parse_args(argv)
    enable_compile_cache()

    cfg, true_scene = build(args.width, args.height)
    cam = Camera(pos=jnp.asarray(default_camera().pos),
                 rot=jnp.asarray(default_camera().rot))

    # Prove the occluder is invisible to primary rays: without shadows the
    # image does not change when it is removed.
    no_occ = true_scene.replace(spheres=true_scene.spheres.replace(
        active=jnp.asarray(true_scene.spheres.active).at[1].set(0.0)))
    lit_cfg = cfg.replace(shadows=False)
    img_with = render_frame_soft(true_scene, cam, lit_cfg, tau=args.tau).rgb
    img_without = render_frame_soft(no_occ, cam, lit_cfg, tau=args.tau).rgb
    occ_visible = float(jnp.max(jnp.abs(img_with - img_without)))
    print(f"occluder silhouette contribution (unshadowed): {occ_visible:.2e} "
          f"(must be ~0: out of frustum)")

    target = render_frame_soft(true_scene, cam, cfg, tau=args.tau).rgb
    target = jax.lax.stop_gradient(target)
    shadow_signal = float(jnp.max(jnp.abs(
        target - render_frame_soft(no_occ, cam, cfg, tau=args.tau).rgb)))
    print(f"cast-shadow signal in the target: {shadow_signal:.1f}/255")

    true_xz = jnp.asarray([TRUE_OCCLUDER[0], TRUE_OCCLUDER[2]], jnp.float32)
    y_known = jnp.float32(TRUE_OCCLUDER[1])

    def scene_at(xz):
        c = jnp.stack([xz[0], y_known, xz[1]])
        return true_scene.replace(spheres=true_scene.spheres.replace(
            center=jnp.asarray(true_scene.spheres.center).at[1].set(c)))

    def loss_fn(xz):
        fb = render_frame_soft(scene_at(xz), cam, cfg, tau=args.tau)
        return jnp.mean(((fb.rgb - target) / 255.0) ** 2)

    opt = optax.adam(args.lr)
    xz = true_xz + jnp.asarray(args.offset, jnp.float32)
    opt_state = opt.init(xz)

    @jax.jit
    def step(xz, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(xz)
        updates, opt_state = opt.update(grads, opt_state, xz)
        return optax.apply_updates(xz, updates), opt_state, loss

    err0 = float(np.linalg.norm(args.offset))
    t0 = time.perf_counter()
    for i in range(args.steps):
        xz, opt_state, loss = step(xz, opt_state)
        if i == 0:
            loss0 = float(loss)
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            err = float(jnp.linalg.norm(xz - true_xz))
            print(f"step {i:4d}  loss {float(loss):.6f}  occluder error {err:.3f}",
                  flush=True)
    dt = time.perf_counter() - t0

    err = float(jnp.linalg.norm(xz - true_xz))
    print(f"\n{args.steps} steps in {dt:.1f}s")
    print(f"loss: {loss0:.6f} -> {float(loss):.6f}")
    print(f"occluder (x, z) error: {err0:.3f} -> {err:.3f} "
          f"(recovered through its shadow alone)")
    ok = occ_visible < 1e-3 and err < 0.2 * err0
    print("FIT OK" if ok else "FIT DID NOT CONVERGE")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
