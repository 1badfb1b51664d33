"""Multi-PROCESS sharded-train-step record.

tests/test_multihost.py proves the 2-process jax.distributed path works;
this harness RECORDS it as a benchmark artifact: it spawns N worker
processes (each one "host" with 2 virtual CPU devices), initializes the
production multihost runtime (rtwc_tpu.dist.initialize_multihost),
builds ONE global mesh spanning every process's devices, and times the
fully-sharded shadowed+animated train step - gradients pmean across the
process boundary every step.

The record is tagged "simulated": true and carries NO efficiency field:
virtual CPU devices serialize on one socket, so this measures topology
and correctness (the cross-process collective runs, losses agree
bit-identically), never scaling. Real >=90% efficiency needs real
devices (BASELINE config 5); this is the recordable part of that story
on a machine without them.

    python benchmarks/multiproc_scaling.py [--procs 2] [--iters 5]
Prints one JSON record on stdout (optionally appends to --out).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_PORT = 12967


def worker(coordinator: str, num_procs: int, proc_id: int, width: int,
           height: int, spheres: int, iters: int) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)

    from rtwc_tpu.dist import initialize_multihost

    ok = initialize_multihost(coordinator_address=coordinator,
                             num_processes=num_procs, process_id=proc_id)
    assert ok, "initialize_multihost declined"
    n_global = jax.device_count()

    import jax.numpy as jnp
    import optax

    from rtwc_tpu.camera import default_camera
    from rtwc_tpu.config import RenderConfig
    from rtwc_tpu.dist import make_mesh, make_sharded_train_step
    from rtwc_tpu.scene import random_scene

    cfg = RenderConfig(width=width, height=height, max_spheres=spheres,
                       max_planes=2, soft_miss_penalty=300.0,
                       soft_mask_k=10.0, shadows=True)
    scene = random_scene(spheres, max_spheres=spheres, max_planes=2, seed=0)
    cam = default_camera()
    mesh = make_mesh()  # all global devices: rows sharded across processes
    step = make_sharded_train_step(cfg, mesh, tau=0.5,
                                   optimizer=optax.adam(1e-2), animate=True)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    params = (scene, cam)
    opt_state = step.init(params)
    tick = 1.0 / 60.0
    params, opt_state, loss = step(params, opt_state, target, tick)
    loss0 = float(loss)  # compile + warm; also the cross-process agreement probe
    t0 = time.perf_counter()
    for _ in range(iters):
        params, opt_state, loss = step(params, opt_state, target, tick)
    lossN = float(loss)
    dt = (time.perf_counter() - t0) / iters
    print(f"WORKER {proc_id} n_global={n_global} ms_per_step={dt*1e3:.3f} "
          f"loss0={loss0:.10e} lossN={lossN:.10e}", flush=True)
    jax.distributed.shutdown()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--spheres", type=int, default=16)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--worker", type=int, default=-1, help=argparse.SUPPRESS)
    p.add_argument("--coordinator", type=str, default="", help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.worker >= 0:
        return worker(args.coordinator, args.procs, args.worker,
                      args.width, args.height, args.spheres, args.iters)

    coordinator = f"127.0.0.1:{_PORT}"
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--worker", str(i), "--coordinator", coordinator,
             "--procs", str(args.procs), "--width", str(args.width),
             "--height", str(args.height), "--spheres", str(args.spheres),
             "--iters", str(args.iters)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for i in range(args.procs)
    ]
    outs = [pr.communicate(timeout=900)[0] for pr in procs]
    rcs = [pr.returncode for pr in procs]
    lines = []
    for o in outs:
        lines += [ln for ln in o.splitlines() if ln.startswith("WORKER")]
    if any(rcs) or len(lines) != args.procs:
        for o in outs:
            sys.stderr.write(o)
        print(json.dumps({"ok": False, "rcs": rcs}))
        return 1
    fields = [dict(kv.split("=") for kv in ln.split()[2:]) for ln in lines]
    # Agreement is per-field: every worker must report the SAME loss0 and
    # the SAME lossN. (A combined set-size check would misread the
    # loss0 == lossN case - a converged/degenerate run - as disagreement.)
    agree = (len({f["loss0"] for f in fields}) == 1
             and len({f["lossN"] for f in fields}) == 1)
    record = {
        "kind": "multiprocess_topology_proof",
        "config": {"width": args.width, "height": args.height,
                   "spheres": args.spheres, "tau": 0.5, "backend": "jnp",
                   "animate": True, "shadows": True},
        "processes": args.procs,
        "devices_per_process": 2,
        "n_devices_global": int(fields[0]["n_global"]),
        "ms_per_step": [float(f["ms_per_step"]) for f in fields],
        "loss_agreement_bit_identical": agree,
        "simulated": True,
        "note": "virtual CPU devices across 2 OS processes; proves the "
                "jax.distributed mesh + cross-process pmean in the sharded "
                "shadowed train step; timing is correctness-only, no "
                "efficiency claim",
    }
    print(json.dumps(record))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(record) + "\n")
    return 0 if record["loss_agreement_bit_identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
