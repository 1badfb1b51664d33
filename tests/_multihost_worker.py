"""Worker process for tests/test_multihost.py.

Each worker is one 'host' of a 2-process jax.distributed CPU cluster
(SURVEY.md section 5 'Distributed communication backend': the reference has
none - cudaMemcpy/DeviceSynchronize only, RayTracingManager.cu:83,137-143 -
so the equivalent here is the JAX multi-process runtime). The worker
initializes through rtwc_tpu.dist.initialize_multihost (the production
entry point), builds ONE GLOBAL mesh spanning both processes' devices, and
runs one sharded train step; gradients pmean across the process boundary.

Run:  python tests/_multihost_worker.py <coordinator> <num_procs> <proc_id>
Prints 'LOSS <value>' on success; both processes must print the same value
(the loss is pmean-reduced over the global mesh, so agreement proves the
cross-process collective actually ran).
"""
import sys


def main() -> int:
    coordinator, num_procs, proc_id = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)  # 2 local devices per "host"

    from rtwc_tpu.dist import initialize_multihost

    ok = initialize_multihost(
        coordinator_address=coordinator, num_processes=num_procs, process_id=proc_id
    )
    assert ok, "initialize_multihost declined to initialize"
    assert jax.process_count() == num_procs, jax.process_count()
    n_global = jax.device_count()
    assert n_global == 2 * num_procs, (n_global, jax.local_device_count())

    import jax.numpy as jnp
    import optax

    from rtwc_tpu.camera import default_camera
    from rtwc_tpu.config import RenderConfig
    from rtwc_tpu.dist import make_mesh, make_sharded_train_step
    from rtwc_tpu.scene import random_scene

    cfg = RenderConfig(width=64, height=8 * n_global, max_spheres=8,
                       max_planes=2, soft_miss_penalty=300.0, soft_mask_k=10.0)
    scene = random_scene(4, max_spheres=8, max_planes=2, seed=0)
    cam = default_camera()

    mesh = make_mesh()  # all global devices; rows sharded across processes
    step = make_sharded_train_step(cfg, mesh, tau=0.5,
                                   optimizer=optax.adam(1e-2), animate=True)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    params = (scene, cam)
    opt_state = step.init(params)
    params, opt_state, loss = step(params, opt_state, target, 1.0 / 60.0)
    loss = float(loss)
    assert loss == loss and abs(loss) < 1e9, loss
    print(f"LOSS {loss:.10e}", flush=True)
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
