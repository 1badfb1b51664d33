"""Smoke test of the main path on one GPU: python3 chip_smoke.py

Runs, through the entry points a user calls:
  1. the hard display kernel at 1920x500 (20 spheres) against the jnp
     reference render_frame;
  2. the fused shadowed MSE train kernel at 1080p (20 spheres) against
     jax.value_and_grad of the jnp soft renderer + MSE: loss, scene and
     camera gradients;
  3. the interactive Engine (default scene, 1 Hz spawn on, headless
     FramebufferSink) for 30 frames at 1920x500 and at 400x150;
  4. optax.adam train steps on render_soft_mse_loss: shadowed 1080p with
     20 spheres and 4K with 200 spheres;
  5. the card-only tests (tests/test_gpu.py).
Every phase that compiles a kernel checks that the lowered program holds
the Triton kernel's custom call, so no phase can have fallen back to a
reference or the interpreter. Any failure raises (exit code != 0).

python3 chip_smoke.py --devices 4 instead runs only the paths across four
cards: make_sharded_train_step (shadowed, animated, 4K/200, 540 rows a
card) against the same step on a one-card mesh, and render_frame_sharded
at 1920x500 against the unsharded kernel render.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

TRITON_CALL = "xla.gpu.triton"
TAU = 0.5
# Soft-renderer settings of the train configurations (BASELINE configs 3-5).
SOFT = dict(soft_miss_penalty=300.0, soft_mask_k=10.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def assert_triton(lowered, what: str) -> None:
    n = lowered.as_text().count(TRITON_CALL)
    if n < 1:
        raise AssertionError(f"{what}: no Triton kernel in the lowered program")
    log(f"  {what}: lowered program holds {n} Triton kernel call(s)")


def timed(fn, *args):
    """(result, seconds) of fn(*args), waited on."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def hard_parity(ref, ker, atol=2e-3, rtol=1e-4, max_frac=0.005):
    """Hard-kernel parity on a frame: hit masks and rgb/depth/normal on
    common hits (atol/rtol per value). Pixels whose hit flag differs, or
    whose values differ beyond the tolerance, must together be fewer than
    max_frac of the frame: two float32 programs resolve grazing
    (silhouette) rays differently. Returns the measured errors."""
    hr, hk = np.asarray(ref.hit), np.asarray(ker.hit)
    both = hr & hk
    bad = hr != hk
    errs = {"hit_mismatch_frac": float(np.mean(hr != hk))}
    for name in ("rgb", "depth", "normal"):
        a = np.asarray(getattr(ref, name), np.float64)
        b = np.asarray(getattr(ker, name), np.float64)
        out = np.abs(a - b) > atol + rtol * np.abs(a)
        if out.ndim == 3:
            out = out.any(axis=-1)
        bad |= both & out
        errs[f"{name}_max_abs"] = float(np.abs(a - b)[both].max()) if both.any() else 0.0
        errs[f"{name}_out_of_tol_frac"] = float(np.mean(both & out))
    errs["mismatch_frac"] = float(np.mean(bad))
    if errs["mismatch_frac"] >= max_frac:
        raise AssertionError(f"hard kernel parity: {errs}")
    return errs


def tree_parity(ref, got, rtol=2e-2, atol=1e-6):
    """Elementwise |a - b| <= atol + rtol * max(|a|, |b|) on every leaf;
    returns the worst violation ratio (<= 1 passes)."""
    import jax

    worst = 0.0
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        lim = atol + rtol * np.maximum(np.abs(a), np.abs(b))
        worst = max(worst, float(np.max(np.abs(a - b) / lim)))
    if worst > 1.0:
        raise AssertionError(f"gradient parity: worst |diff|/tol = {worst:.3g}")
    return worst


def rel_err(ref, got) -> float:
    a, b = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def phase_hard():
    import jax

    from rtwc_tpu.camera import default_camera
    from rtwc_tpu.config import RenderConfig
    from rtwc_tpu.render import render_frame
    from rtwc_tpu.render.pallas_kernel import _render_pallas_jit, render_frame_pallas
    from rtwc_tpu.render import tiles
    from rtwc_tpu.scene import random_scene

    log("[hard] display kernel, 1920x500, 20 spheres")
    cfg = RenderConfig(width=1920, height=500, max_spheres=32, max_planes=4)
    scene, cam = random_scene(20, max_spheres=32, max_planes=4, seed=0), default_camera()
    bh, bw = tiles.pick_tile(cfg.height, cfg.width)
    assert_triton(_render_pallas_jit.lower(scene, cam, config=cfg, bh=bh, bw=bw,
                                           interpret=False), "hard render")
    ker, t = timed(lambda: render_frame_pallas(scene, cam, cfg))
    log(f"  set-up (compile + first call): {t:.2f} s")
    ref = jax.jit(lambda s, c: render_frame(s, c, cfg))(scene, cam)
    log(f"  parity vs render_frame: {json.dumps(hard_parity(ref, ker))}")


def _soft_loss_pair(cfg, scene, cam, target):
    import jax
    import jax.numpy as jnp

    from rtwc_tpu.render import render_frame_soft
    from rtwc_tpu.render.pallas_soft import render_soft_mse_loss

    def ref_loss(p):
        rgb = render_frame_soft(p[0], p[1], cfg, tau=TAU).rgb
        return jnp.mean(((rgb - target) / 255.0) ** 2)

    def ker_loss(p):
        return render_soft_mse_loss(p[0], p[1], target, cfg, tau=TAU)

    return (jax.jit(jax.value_and_grad(ref_loss)),
            jax.jit(jax.value_and_grad(ker_loss)))


def phase_soft():
    import jax.numpy as jnp

    from rtwc_tpu.camera import Camera, default_camera
    from rtwc_tpu.config import RenderConfig
    from rtwc_tpu.scene import random_scene

    log("[soft] fused shadowed MSE train kernel, 1080p, 20 spheres")
    cfg = RenderConfig(width=1920, height=1080, max_spheres=20, max_planes=4,
                       shadows=True, **SOFT)
    scene = random_scene(20, max_spheres=20, max_planes=4, seed=0)
    cam = Camera(pos=jnp.asarray(default_camera().pos),
                 rot=jnp.asarray(default_camera().rot))
    target = jnp.full((cfg.height, cfg.width, 3), 60.0, jnp.float32)
    ref_vg, ker_vg = _soft_loss_pair(cfg, scene, cam, target)
    params = (scene, cam)
    assert_triton(ker_vg.lower(params), "fused train loss")
    (lk, gk), t = timed(ker_vg, params)
    log(f"  set-up (compile + first call): {t:.2f} s")
    lr, gr = ref_vg(params)
    loss_rel = abs(float(lk) - float(lr)) / abs(float(lr))
    if loss_rel > 1e-4:
        raise AssertionError(f"fused loss relative error {loss_rel:.3g} > 1e-4")
    worst = tree_parity(gr[0], gk[0])
    worst_cam_pos = tree_parity(gr[1].pos, gk[1].pos)
    rot = rel_err(gr[1].rot, gk[1].rot)
    if rot > 1.5e-2:
        raise AssertionError(f"camera rotation relative error {rot:.3g} > 1.5e-2")
    log("  parity vs jnp render_frame_soft + MSE: " + json.dumps({
        "loss_rel": loss_rel, "scene_grad_worst_over_tol": worst,
        "cam_pos_grad_worst_over_tol": worst_cam_pos, "cam_rot_rel": rot}))


def phase_engine():
    import jax

    from rtwc_tpu.config import EngineConfig, RenderConfig
    from rtwc_tpu.engine import Engine
    from rtwc_tpu.engine.engine import _render_step
    from rtwc_tpu.io import FramebufferSink

    for width, height in ((1920, 500), (400, 150)):
        log(f"[engine] {width}x{height}, default scene, 1 Hz spawn, 30 frames")
        sink = FramebufferSink(keep_all=True)
        engine = Engine(RenderConfig(width=width, height=height),
                        EngineConfig(spawn=True, show_fps=False, seed=0),
                        presenter=sink, interactive=False)
        assert_triton(_render_step.lower(engine.scene, engine.camera,
                                         np.float32(0.0), engine.rcfg),
                      "engine render step")
        n0 = engine.scene.n_spheres
        t0 = time.perf_counter()
        engine.run(max_frames=30)
        dt = time.perf_counter() - t0
        if len(sink.frames) != 30 or not all(
                f.count(b"\n") == height for f in sink.frames):
            raise AssertionError("engine did not publish 30 whole frames")
        log(f"  30 frames in {dt:.2f} s (first frame compiles); "
            f"spheres {n0} -> {engine.scene.n_spheres}; "
            f"frame bytes {len(sink.frames[-1])}")
        jax.clear_caches()


def phase_train():
    import jax
    import jax.numpy as jnp
    import optax

    from rtwc_tpu.camera import Camera, default_camera
    from rtwc_tpu.config import RenderConfig
    from rtwc_tpu.render.pallas_soft import render_soft_mse_loss
    from rtwc_tpu.scene import random_scene

    for (w, h, n) in ((1920, 1080, 20), (3840, 2160, 200)):
        log(f"[train] adam on render_soft_mse_loss, {w}x{h}, {n} spheres, shadows")
        cfg = RenderConfig(width=w, height=h, max_spheres=n, max_planes=4,
                           shadows=True, **SOFT)
        params = (random_scene(n, max_spheres=n, max_planes=4, seed=0),
                  Camera(pos=jnp.asarray(default_camera().pos),
                         rot=jnp.asarray(default_camera().rot)))
        target = jnp.zeros((h, w, 3), jnp.float32)
        opt = optax.adam(1e-2)

        @jax.jit
        def step(p, st):
            loss, g = jax.value_and_grad(
                lambda q: render_soft_mse_loss(q[0], q[1], target, cfg, tau=TAU))(p)
            upd, st = opt.update(g, st, p)
            return optax.apply_updates(p, upd), st, loss

        st = opt.init(params)
        assert_triton(step.lower(params, st), "train step")
        (params, st, l0), t = timed(step, params, st)
        log(f"  set-up (compile + first step): {t:.2f} s")
        losses = [float(l0)]
        t0 = time.perf_counter()
        for _ in range(4):
            params, st, loss = step(params, st)
            losses.append(float(loss))
        dt = (time.perf_counter() - t0) / 4
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"train losses {losses}")
        log(f"  losses {[round(x, 6) for x in losses]}; {dt * 1e3:.2f} ms/step "
            f"(host clock, incl. the loss fetch)")
        jax.clear_caches()


def phase_card_tests():
    import importlib.util
    import inspect
    import os

    # Loaded by path: another installed package may own the name "tests".
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_gpu.py")
    spec = importlib.util.spec_from_file_location("test_gpu", path)
    test_gpu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(test_gpu)
    for name, fn in inspect.getmembers(test_gpu, inspect.isfunction):
        if name.startswith("test_"):
            log(f"[card test] {name}")
            fn(gpu=None)


def phase_four_cards():
    import jax
    import jax.numpy as jnp
    import optax

    from rtwc_tpu.camera import Camera, default_camera
    from rtwc_tpu.config import RenderConfig
    from rtwc_tpu.dist import make_mesh, make_sharded_train_step, render_frame_sharded
    from rtwc_tpu.render.pallas_kernel import render_frame_pallas
    from rtwc_tpu.scene import random_scene

    log("[4 cards] make_sharded_train_step, 4K/200, shadowed, animated, 540 rows a card")
    cfg = RenderConfig(width=3840, height=2160, max_spheres=200, max_planes=4,
                       shadows=True, **SOFT)
    params = (random_scene(200, max_spheres=200, max_planes=4, seed=0),
              Camera(pos=jnp.asarray(default_camera().pos),
                     rot=jnp.asarray(default_camera().rot)))
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    # One SGD step at learning rate 1: the parameter change is minus the
    # gradient, so the comparison is a gradient comparison.
    results = {}
    for n in (4, 1):
        step = make_sharded_train_step(cfg, make_mesh(n), tau=TAU,
                                       optimizer=optax.sgd(1.0), animate=True)
        st = step.init(params)
        assert_triton(step.lower(params, st, target, 1.0 / 60.0),
                      f"{n}-card train step")
        (new_params, _, loss), t = timed(step, params, st, target, 1.0 / 60.0)
        log(f"  {n} card(s): loss {float(loss):.8g}, set-up {t:.2f} s")
        results[n] = (float(loss), jax.tree.map(lambda a, b: a - b,
                                                new_params, params))
    loss_rel = abs(results[4][0] - results[1][0]) / abs(results[1][0])
    if loss_rel > 1e-5:
        raise AssertionError(f"4-card loss differs: rel {loss_rel:.3g}")
    scale = max(float(np.max(np.abs(np.asarray(x))))
                for x in jax.tree.leaves(results[1][1]))
    worst = tree_parity(results[1][1], results[4][1], atol=1e-3 * scale)
    log(f"  4 vs 1 card: loss rel {loss_rel:.3g}, update worst |diff|/tol "
        f"{worst:.3g} (tol 2e-2 rel + 1e-3 of the largest update {scale:.3g})")

    log("[4 cards] render_frame_sharded, 1920x500, 20 spheres")
    cfg = RenderConfig(width=1920, height=500, max_spheres=32, max_planes=4)
    scene, cam = random_scene(20, max_spheres=32, max_planes=4, seed=0), default_camera()
    fb4 = render_frame_sharded(scene, cam, cfg, make_mesh(4))
    fb1 = render_frame_pallas(scene, cam, cfg)
    diff = {name: float(np.abs(np.asarray(getattr(fb4, name))
                               - np.asarray(getattr(fb1, name))).max())
            for name in ("rgb", "depth", "normal")}
    log(f"  4-card vs unsharded max |diff|: {json.dumps(diff)}")
    if diff["rgb"] > 1e-3 or diff["normal"] > 1e-5 or diff["depth"] > 1e-2:
        raise AssertionError("sharded display render differs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card paths")
    args = ap.parse_args(argv)

    import jax

    from rtwc_tpu.utils.compile_cache import enable_compile_cache

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {jax.default_backend()!r})",
              file=sys.stderr)
        return 1
    if len(jax.devices()) < args.devices:
        print(f"chip_smoke: needs {args.devices} GPUs, found {len(jax.devices())}",
              file=sys.stderr)
        return 1
    log(f"compile cache: {enable_compile_cache()}")
    dev = jax.devices()[0]
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    t0 = time.perf_counter()
    if args.devices == 4:
        phase_four_cards()
    else:
        phase_hard()
        phase_soft()
        phase_engine()
        phase_train()
        phase_card_tests()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
