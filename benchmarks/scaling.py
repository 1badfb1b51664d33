"""Scaling-efficiency harness (BASELINE: >=90% rays/s efficiency from
1 device to N, tile-sharded).

Measures the sharded train step's wall-clock per frame at mesh sizes
1..N over the same *global* image, reporting rays/s and parallel
efficiency. On a machine with several GPUs run it as:

    python benchmarks/scaling.py --width 1920 --height 1080 --spheres 100

On a development machine without multiple cards, --simulate 8 forces an
8-virtual-device CPU mesh (correctness/topology only - CPU timings do not
predict GPU efficiency).

Multi-process: launch one process per host with JAX_COORDINATOR_ADDRESS
set; rtwc_tpu.dist.initialize_multihost() picks it up and the mesh spans
every process's devices.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--spheres", type=int, default=100)
    p.add_argument("--tau", type=float, default=0.5)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--simulate", type=int, default=0,
                   help="force an N-virtual-device CPU mesh (topology testing)")
    p.add_argument("--sizes", type=str, default="",
                   help="comma-separated mesh sizes (default: 1,2,4,...,n_devices)")
    p.add_argument("--shadows", action="store_true",
                   help="differentiable hard shadows in the train step "
                        "(the headline bench's full feature set)")
    p.add_argument("--animate", action="store_true",
                   help="tick the sphere physics (update_scene) every step "
                        "inside the sharded train step (BASELINE config 4)")
    p.add_argument("--out", type=str, default="",
                   help="also append the result record to this JSON-lines file")
    args = p.parse_args(argv)

    if args.simulate:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.simulate)

    import jax
    import jax.numpy as jnp
    import optax

    from rtwc_tpu.camera import default_camera
    from rtwc_tpu.config import RenderConfig
    from rtwc_tpu.dist import make_mesh, make_sharded_train_step, initialize_multihost
    from rtwc_tpu.scene import random_scene

    initialize_multihost()
    n_dev = jax.device_count()
    sizes = ([int(s) for s in args.sizes.split(",") if s]
             or [n for n in (1, 2, 4, 8, 16, 32, 64, 128, 256) if n <= n_dev])

    cfg = RenderConfig(width=args.width, height=args.height,
                       max_spheres=args.spheres, max_planes=4,
                       soft_miss_penalty=300.0, soft_mask_k=10.0,
                       shadows=args.shadows)
    scene = random_scene(args.spheres, max_spheres=args.spheres, max_planes=4, seed=0)
    cam = default_camera()
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    rays = cfg.width * cfg.height

    def sync(x):
        return float(jnp.ravel(jax.tree.leaves(x)[0])[0])

    # Efficiency semantics: an `efficiency` number is
    # emitted ONLY when (a) the devices are real parallel hardware (not a
    # virtual CPU mesh, whose shards serialize on one socket) and (b) there
    # is a smaller mesh in the same run to compare against. Simulated runs
    # are tagged `"simulated": true` - they prove sharding correctness and
    # topology, never scaling.
    simulated = bool(args.simulate) or jax.default_backend() == "cpu"
    results = []
    base = None  # (n, rays_per_s) of the smallest measured mesh
    for n in sizes:
        if cfg.height % n:
            print(f"# skip n={n}: height {cfg.height} not divisible", file=sys.stderr)
            continue
        mesh = make_mesh(n)
        step = make_sharded_train_step(cfg, mesh, tau=args.tau,
                                       optimizer=optax.adam(1e-2),
                                       animate=args.animate)
        params = (scene, cam)
        opt_state = step.init(params)
        tick = 1.0 / 60.0
        params, opt_state, loss = step(params, opt_state, target, tick)
        sync(loss)  # compile + warm
        params, opt_state, loss = step(params, opt_state, target, tick)
        sync(loss)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            params, opt_state, loss = step(params, opt_state, target, tick)
        sync(loss)
        dt = (time.perf_counter() - t0) / args.iters
        rps = rays / dt
        row = {"mesh": n, "ms_per_step": round(dt * 1e3, 3),
               "rays_per_s": round(rps, 1)}
        eff_txt = ""
        if simulated:
            row["simulated"] = True
        elif base is None:
            base = (n, rps)
        else:
            eff = rps * base[0] / (base[1] * n)
            row["efficiency"] = round(eff, 4)
            eff_txt = f"  eff={eff*100:5.1f}% (vs mesh={base[0]})"
        results.append(row)
        print(f"mesh={n:3d}  {dt*1e3:8.2f} ms/step  {rps/1e6:8.1f} Mrays/s"
              + (eff_txt or ("  [simulated: topology only]" if simulated else "")),
              file=sys.stderr)

    record = {
        "config": {"width": cfg.width, "height": cfg.height,
                   "spheres": args.spheres, "tau": args.tau,
                   "animate": args.animate,
                   "shadows": args.shadows, "simulate": args.simulate},
        "platform": jax.default_backend(),
        "n_devices": n_dev,
        "results": results,
    }
    print(json.dumps(record))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(record) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
