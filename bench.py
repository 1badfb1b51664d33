"""Kernel-versus-XLA benchmark on one GPU: python bench.py

For each hand-written kernel, times the jitted call through its user
entry point beside what XLA makes of the plain jnp version of the same
computation, in turns (kernel, XLA, kernel, XLA) inside one process:

  - hard display kernel (render_frame_pallas) vs jax.jit(render_frame):
    the Engine's default scene and pool capacity at 1920x500 and 400x150
    (the reference's high and low resolutions), and a 20-sphere scene at
    1920x500;
  - one-pass fused MSE train kernel (value_and_grad of
    render_soft_mse_loss) vs value_and_grad of the jnp soft renderer +
    MSE: 1080p/20 spheres with and without shadows (plain jnp), and
    4K/200 spheres with shadows (row-chunked, rematerialized jnp
    softmin.band_mse_loss - the plain version does not fit in memory).

Times are host-clock wall time per call after a warm-up call, waited on
with block_until_ready, with the inputs already on the card; compile time
is reported separately as set-up.
Fails without a GPU: it never times the interpreter or a CPU. Prints a
human summary on stderr and ONE JSON line on stdout.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

from rtwc_tpu.camera import Camera, default_camera
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.render import render_frame, render_frame_soft
from rtwc_tpu.render.pallas_kernel import render_frame_pallas
from rtwc_tpu.render.pallas_soft import render_soft_mse_loss
from rtwc_tpu.render.softmin import band_mse_loss
from rtwc_tpu.scene import default_scene, random_scene
from rtwc_tpu.utils.compile_cache import enable_compile_cache

TAU = 0.5
SOFT = dict(soft_miss_penalty=300.0, soft_mask_k=10.0)
ROUNDS = 2  # kernel, XLA, kernel, XLA


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def setup_time(fn, args):
    """Seconds of the first call: compile plus one run."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def per_call(fn, args, iters):
    """Seconds per call over `iters` back-to-back calls."""
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def compare(name, kernel_fn, xla_fn, args, iters, rays):
    """Set-up of both, then per-call times in turns."""
    rec = {"kernel_setup_s": setup_time(kernel_fn, args),
           "xla_setup_s": setup_time(xla_fn, args)}
    k, x = [], []
    for _ in range(ROUNDS):
        k.append(per_call(kernel_fn, args, iters))
        x.append(per_call(xla_fn, args, iters))
    rec.update(kernel_ms=[t * 1e3 for t in k], xla_ms=[t * 1e3 for t in x],
               speedup=min(x) / min(k), kernel_rays_per_s=rays / min(k))
    print(f"{name:28s} kernel {min(k) * 1e3:9.3f} ms  XLA {min(x) * 1e3:9.3f} ms"
          f"  x{rec['speedup']:.2f}  (set-up {rec['kernel_setup_s']:.1f} s /"
          f" {rec['xla_setup_s']:.1f} s)", file=sys.stderr, flush=True)
    return rec


def display_cell(cfg, scene, iters):
    # Inputs live on the card, as the Engine's donated scene does, and
    # both paths sit inside one jit, as in the Engine's render step, so
    # neither pays a Python wrapper per call.
    args = jax.device_put((scene, default_camera()))
    return compare(
        f"display {cfg.width}x{cfg.height} cap{cfg.max_spheres}",
        jax.jit(lambda s, c: render_frame_pallas(s, c, cfg)),
        jax.jit(lambda s, c: render_frame(s, c, cfg)),
        args, iters, cfg.width * cfg.height)


def train_cell(cfg, n, iters, chunked):
    scene = random_scene(n, max_spheres=n, max_planes=4, seed=0)
    cam = Camera(pos=jnp.asarray(default_camera().pos),
                 rot=jnp.asarray(default_camera().rot))
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)

    def xla_loss(p):
        if chunked:
            return band_mse_loss(p[0], p[1], target, cfg, TAU)
        rgb = render_frame_soft(p[0], p[1], cfg, tau=TAU).rgb
        return jnp.mean(((rgb - target) / 255.0) ** 2)

    return compare(
        f"train {cfg.width}x{cfg.height}/{n}{' sh' if cfg.shadows else ''}",
        jax.jit(jax.value_and_grad(
            lambda p: render_soft_mse_loss(p[0], p[1], target, cfg, tau=TAU))),
        jax.jit(jax.value_and_grad(xla_loss)),
        (jax.device_put((scene, cam)),), iters, cfg.width * cfg.height)


def main() -> int:
    if jax.default_backend() != "gpu":
        print(f"bench: no GPU (JAX platform {jax.default_backend()!r})",
              file=sys.stderr)
        return 1
    cache = enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    name_power = card()
    print(f"# {name_power} | {device} | compile cache {cache}", file=sys.stderr)

    cells = {}
    for w, h in ((1920, 500), (400, 150)):
        cfg = RenderConfig(width=w, height=h)
        cells[f"display_{w}x{h}_default"] = display_cell(cfg, default_scene(cfg), 50)
    cfg = RenderConfig(width=1920, height=500, max_spheres=32, max_planes=4)
    cells["display_1920x500_20"] = display_cell(
        cfg, random_scene(20, max_spheres=32, max_planes=4, seed=0), 50)

    hd = RenderConfig(width=1920, height=1080, max_spheres=20, max_planes=4,
                      shadows=True, **SOFT)
    cells["train_1080p_20_shadows"] = train_cell(hd, 20, 10, chunked=False)
    cells["train_1080p_20"] = train_cell(hd.replace(shadows=False), 20, 10,
                                         chunked=False)
    uhd = RenderConfig(width=3840, height=2160, max_spheres=200, max_planes=4,
                       shadows=True, **SOFT)
    cells["train_4k_200_shadows"] = train_cell(uhd, 200, 3, chunked=True)

    head = cells["train_1080p_20_shadows"]
    print(json.dumps({
        "metric": "rays/s fwd+bwd, 1080p, 20 spheres, shadows (fused kernel)",
        "value": head["kernel_rays_per_s"], "unit": "rays/s",
        "device": device, "card": name_power, "cells": cells}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
