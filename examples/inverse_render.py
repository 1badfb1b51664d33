"""Inverse rendering demo (BASELINE config 3): recover sphere geometry and
camera pose from a SHARP target image by coarse-to-fine annealed gradient
descent through the differentiable soft renderer (render/softmin.py).

The reference renderer (CUDA, RayTracing.cu) cannot do any of this - its
closest-hit logic is branch-hard. Here d(pixel)/d(geometry, pose) exists
everywhere (render/softmin.py design note), and the temperature schedule
(render/anneal.py; SURVEY.md section 7's "temperature schedule" hard part)
lets the fit END at display-sharp settings (tau = 0.05) where a
sharp-from-the-start fit stalls: coarse tau widens the silhouette pull-in
range to ~16*tau/penalty world units, then each stage restarts from the
previous solution.

Two phases, because the joint problem is gauge-degenerate (a camera
rotation offset compensates correlated sphere shifts, so "recover both
at once from one image" has a flat valley of wrong-but-consistent
solutions - with known geometry OR known pose each subproblem is
well-posed):

  A. geometry: camera known, perturbed sphere centers recovered to
     sub-pixel REPROJECTION error (the image-plane displacement of the
     projected center; depth along the view ray is measured through the
     projected-size error, since a farther sphere of the same radius is
     the same silhouette scale change);
  B. camera: geometry known, perturbed rotation recovered to below one
     pixel's angular size.

An IoU silhouette loss on the soft alpha channel (Framebuffer.alpha)
augments the RGB loss at coarse stages - the overlap term attracts
displaced silhouettes long before RGB gradients see them - and drops out
at the sharp final stage.

Usage:
    python examples/inverse_render.py [--steps 300] [--width 320] [--height 180]

Prints the per-stage losses and final sub-pixel errors; exit 0 iff both
phases converge sub-pixel.
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

from rtwc_tpu.camera import Camera, basis, default_camera, projection_elements
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.heads.ansi256 import quantize_rgb_ste
from rtwc_tpu.render.anneal import AnnealSchedule
from rtwc_tpu.render import render_frame_soft
from rtwc_tpu.utils.compile_cache import enable_compile_cache
from rtwc_tpu.scene import add_plane, add_sphere, empty_scene


def build(width: int, height: int, n_spheres: int = 3):
    """Demo scene: 3 canonical spheres + a ground plane. For the
    BASELINE config-3 scale run (n_spheres > 3, e.g. 20 @ 1080p) the
    spheres instead tile an IMAGE-SPACE grid at varying depths: every
    sphere is fully visible by construction (projected centers land on
    grid cells, projected radii stay inside them), which keeps the
    single-view geometry recovery identifiable - an occluded sphere has
    no silhouette gradient and CANNOT be recovered by any method, so a
    cluttered random layout measures occlusion, not the optimizer."""
    import math

    n = max(3, n_spheres)
    cfg = RenderConfig(width=width, height=height, max_spheres=max(4, n),
                       max_planes=2,
                       soft_miss_penalty=300.0, soft_mask_k=10.0)
    s = empty_scene(cfg.max_spheres, cfg.max_planes)
    if n <= 3:
        s = add_sphere(s, 5.0, (0.0, 1.0, 22.0), (220.0, 50.0, 50.0), speed=1.0)
        s = add_sphere(s, 3.0, (-5.0, -1.0, 30.0), (50.0, 220.0, 50.0), speed=1.0)
        s = add_sphere(s, 4.0, (6.0, 2.0, 34.0), (50.0, 50.0, 220.0), speed=1.0)
    else:
        e1, e2 = projection_elements(cfg)
        cam = default_camera()
        r_ax, u_ax, f_ax = (np.asarray(v) for v in basis(cam.rot))
        pos = np.asarray(cam.pos)
        cols = max(1, math.ceil(math.sqrt(n * width / height)))
        rows = math.ceil(n / cols)
        phi = 0.6180339887498949
        for k in range(n):
            col, row = k % cols, k // cols
            # NDC direction of the cell center, mapped through the real
            # camera basis: center = pos + (vx*right + vy*up + fwd) * z.
            # The grid stays in the CENTRAL field (|vx| <= 0.35 e1):
            # the reference's anamorphic projection reaches ~81 degrees
            # off-axis at the screen edge, where a sphere's projected
            # CENTER moves ~50 px along near-unobservable directions of
            # the silhouette (measured: image residual 5e-8 with the
            # center metric reading 63 px) - edge placements measure the
            # projection's pathology, not the fit.
            vx = (2.0 * (col + 0.5) / cols - 1.0) * e1 * 0.35
            vy = (2.0 * (row + 0.5) / rows - 1.0) * e2 * 0.6
            z = 22.0 + 20.0 * ((k * phi) % 1.0)
            c = pos + (vx * r_ax + vy * u_ax + f_ax) * z
            # projected radius = 0.30 of the cell half-width -> no
            # projected overlap at any of the depths used here
            r = 0.30 * (0.35 * e1 / cols) * z * 2.0
            # saturated hue-rotated colors: every sphere contrasts hard
            # with the gray ground (a sphere whose shaded color lands
            # near the ground's makes the loss landscape flat around
            # large displacements - measured: camouflaged spheres
            # plateaued 50+ px off at ~zero loss)
            import colorsys
            cr, cg, cb = colorsys.hsv_to_rgb((k * phi) % 1.0, 1.0, 1.0)
            s = add_sphere(
                s, r, (float(c[0]), float(c[1]), float(c[2])),
                (30.0 + 215.0 * cr, 30.0 + 215.0 * cg, 30.0 + 215.0 * cb),
                speed=1.0)
    if n <= 3:
        ground_y = -4.0
    else:
        # below every sphere, so the ground never occludes the grid
        ground_y = float(np.min(np.asarray(s.spheres.center)[:n, 1]
                                - np.asarray(s.spheres.radius)[:n])) - 2.0
    s = add_plane(s, (0.0, ground_y, 30.0), (0.0, 1.0, 0.0),
                  (120.0, 120.0, 120.0), 80.0, 80.0)
    return cfg, s


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300, help="steps per phase")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=180)
    p.add_argument("--tau0", type=float, default=20.0,
                   help="coarsest temperature of the anneal ladder")
    p.add_argument("--tau", type=float, default=0.05,
                   help="final display-sharp temperature (target rendered here)")
    p.add_argument("--anneal", type=int, default=5, help="ladder stages")
    p.add_argument("--lr", type=float, default=3e-2)
    p.add_argument("--w-sil", type=float, default=1.0,
                   help="IoU silhouette loss weight at coarse stages")
    p.add_argument("--perturb", type=float, default=1.5)
    p.add_argument("--quantized", action="store_true",
                   help="fit through the ANSI-256-quantized console image: "
                        "the loss sees only the 256-color frame the terminal "
                        "shows (heads/ansi256.py quantize_rgb_ste straight-"
                        "through estimator keeps it differentiable - the "
                        "head being differentiated is ANSIRGB.h:141-189)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--spheres", type=int, default=3,
                   help="number of spheres (20 @ 1080p = BASELINE config 3)")
    p.add_argument("--json-out", type=str, default=None,
                   help="write a JSON artifact (per-stage losses, final "
                        "errors, wall clock) to this path")
    args = p.parse_args(argv)
    enable_compile_cache()

    cfg, true_scene = build(args.width, args.height, args.spheres)
    e1, e2 = projection_elements(cfg)
    W, H = cfg.width, cfg.height
    sched = AnnealSchedule(n_stages=args.anneal, tau0=args.tau0, tau1=args.tau)
    stages = list(sched.configs(cfg))
    true_cam = Camera(pos=jnp.asarray(default_camera().pos),
                      rot=jnp.asarray(default_camera().rot))
    fb_t = render_frame_soft(true_scene, true_cam, stages[-1][1],
                                    tau=stages[-1][0])
    target_rgb = fb_t.rgb
    if args.quantized:
        # The target is what the terminal actually displays: the
        # ANSI-256-quantized frame. (Plain quantization here; the STE is
        # only needed on the differentiated side.)
        target_rgb = quantize_rgb_ste(target_rgb)
    target = jax.lax.stop_gradient(target_rgb)
    target_a = jax.lax.stop_gradient(fb_t.alpha)

    def fit(params0, labels_fn, lr, fit_stages=None):
        fit_stages = stages if fit_stages is None else fit_stages
        opt = optax.multi_transform(
            {"train": optax.adam(lr), "freeze": optax.set_to_zero()}, labels_fn)
        params, opt_state = params0, None
        opt_state = opt.init(params)

        def make_step(stage_tau, stage_cfg, w_sil):
            def loss_fn(p):
                fb = render_frame_soft(p[0], p[1], stage_cfg, tau=stage_tau)
                rgb = quantize_rgb_ste(fb.rgb) if args.quantized else fb.rgb
                loss = jnp.mean(((rgb - target) / 255.0) ** 2)
                if w_sil:
                    inter = jnp.sum(fb.alpha * target_a)
                    union = jnp.sum(fb.alpha + target_a - fb.alpha * target_a)
                    loss = loss + w_sil * (1.0 - inter / jnp.maximum(union, 1e-6))
                return loss

            @jax.jit
            def step(p, st):
                loss, grads = jax.value_and_grad(loss_fn)(p)
                updates, st = opt.update(grads, st, p)
                return optax.apply_updates(p, updates), st, loss

            return step

        n_stages = len(fit_stages)
        per = [args.steps // n_stages + (1 if i < args.steps % n_stages else 0)
               for i in range(n_stages)]
        stage_log = []
        for si, ((stage_tau, stage_cfg), n) in enumerate(zip(fit_stages, per)):
            w_sil = args.w_sil if si < n_stages - 1 else 0.0
            step = make_step(stage_tau, stage_cfg, w_sil)
            for _ in range(n):
                params, opt_state, loss = step(params, opt_state)
            print(f"  stage tau={stage_tau:7.3f}  loss {float(loss):.6f}",
                  flush=True)
            stage_log.append({"tau": float(stage_tau), "steps": n,
                              "loss": float(loss)})
        return params, float(loss), stage_log

    def project_px(cam, pts):
        """World points -> pixel coordinates under `cam` (camera.py raygen
        inverted: lateral NDC spans +-e1/+-e2 at unit forward depth)."""
        r, u, f = basis(cam.rot)
        B = np.stack([np.asarray(r), np.asarray(u), np.asarray(f)])
        v = (pts - np.asarray(cam.pos)) @ B.T
        return np.stack([v[:, 0] / v[:, 2] / e1 * (W / 2),
                         v[:, 1] / v[:, 2] / e2 * (H / 2)], axis=1)

    rng = np.random.default_rng(args.seed)
    live = np.asarray(true_scene.spheres.active) > 0.5
    idx = np.flatnonzero(live)
    t0 = time.perf_counter()

    # ---- phase A: geometry (camera known) --------------------------------
    noise = rng.normal(0, args.perturb, size=(cfg.max_spheres, 3)).astype(np.float32)
    noise[~live] = 0.0
    bad_scene = true_scene.replace(spheres=true_scene.spheres.replace(
        center=np.asarray(true_scene.spheres.center) + noise))

    def labels_geo(params):
        scene, cam = params
        slab = jax.tree.map(lambda _: "freeze", scene)
        clab = jax.tree.map(lambda _: "freeze", cam)
        return (slab.replace(spheres=slab.spheres.replace(center="train")), clab)

    print(f"phase A: recover sphere centers (max perturbation "
          f"{np.linalg.norm(noise[idx], axis=1).max():.2f} world units)")
    # Cosine-decayed adam: the coarse stages may orbit their optimum
    # (adam overshoot on steep silhouette bowls); decaying to zero makes
    # every phase SETTLE by construction instead of handing the next
    # stage whatever pose the last step happened to land on - without
    # decay, convergence at these step budgets depends on float-ULP luck
    # (it flipped when kernel tile defaults changed the target's last
    # bits).
    (fit_scene, _), _, log_a = fit((bad_scene, true_cam), labels_geo,
                                   optax.cosine_decay_schedule(args.lr, args.steps))

    tp = project_px(true_cam, np.asarray(true_scene.spheres.center)[idx])
    fp = project_px(true_cam, np.asarray(fit_scene.spheres.center)[idx])
    reproj = np.linalg.norm(tp - fp, axis=1)
    z_t = np.asarray(true_scene.spheres.center)[idx, 2]
    z_f = np.asarray(fit_scene.spheres.center)[idx, 2]
    radii = np.asarray(true_scene.spheres.radius)[idx]
    size_px = np.abs(radii / z_f - radii / z_t) / e1 * (W / 2)
    reproj0 = np.linalg.norm(
        tp - project_px(true_cam, np.asarray(bad_scene.spheres.center)[idx]), axis=1)

    # ---- phase B: camera pose (geometry known). Pitch/yaw only: the
    # camera basis has no roll, reference parity (Camera3D.cpp:53-75).
    bad_cam = true_cam.replace(rot=true_cam.rot + jnp.asarray([0.02, -0.03, 0.0]))

    def labels_cam(params):
        scene, cam = params
        slab = jax.tree.map(lambda _: "freeze", scene)
        clab = jax.tree.map(lambda _: "freeze", cam)
        return (slab, clab.replace(rot="train"))

    print("phase B: recover camera rotation (perturbation 0.036 rad)")
    # The pose subproblem is smooth at any tau; two stages suffice, and
    # most of the budget goes to polishing at the sharp temperature
    # (same cosine decay rationale as phase A).
    (_, fit_cam), _, log_b = fit((true_scene, bad_cam), labels_cam,
                                 optax.cosine_decay_schedule(5e-3, args.steps),
                                 fit_stages=stages[-2:])
    rot_err = np.abs(np.asarray(fit_cam.rot) - np.asarray(true_cam.rot)).max()
    px_angle = 2.0 * e1 / W  # one pixel's angular size at image center

    dt = time.perf_counter() - t0
    print(f"\n2 x {args.steps} steps in {dt:.1f}s")
    print(f"phase A reprojection error: {np.round(reproj0, 2)} -> "
          f"{np.round(reproj, 3)} px; size error {np.round(size_px, 3)} px")
    print(f"phase B rotation error: {rot_err:.5f} rad "
          f"({rot_err / px_angle:.2f} pixel-angles)")
    ok_a = bool((reproj < 1.0).all() and (size_px < 1.0).all())
    ok_b = bool(rot_err < px_angle)
    print(f"phase A {'OK (sub-pixel)' if ok_a else 'DID NOT CONVERGE'} | "
          f"phase B {'OK (sub-pixel)' if ok_b else 'DID NOT CONVERGE'}")
    if args.json_out:
        import json

        rec = {
            "kind": "inverse_render_fit",
            "config": {"width": W, "height": H,
                       "spheres": int(live.sum()), "planes": 1,
                       "steps_per_phase": args.steps,
                       "anneal_stages": args.anneal,
                       "tau0": args.tau0, "tau": args.tau,
                       "perturb_world_units": args.perturb,
                       "quantized": bool(args.quantized)},
            "backend": jax.default_backend(),
            "device": str(jax.devices()[0]),
            "phase_a_stages": log_a,
            "phase_b_stages": log_b,
            "phase_a_reproj_px_before": np.round(reproj0, 3).tolist(),
            "phase_a_reproj_px_after": np.round(reproj, 4).tolist(),
            "phase_a_size_err_px": np.round(size_px, 4).tolist(),
            "phase_b_rot_err_rad": float(rot_err),
            "phase_b_rot_err_pixel_angles": float(rot_err / px_angle),
            "wall_clock_s": round(dt, 1),
            "sub_pixel": bool(ok_a and ok_b),
        }
        with open(args.json_out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0 if (ok_a and ok_b) else 1


if __name__ == "__main__":
    sys.exit(main())
