"""Multi-host runtime bootstrap.

The reference's only 'communication backend' is cudaMemcpy +
cudaDeviceSynchronize inside one process (RayTracingManager.cu:83,137-143).
Here it is the JAX distributed runtime (SURVEY.md section 5): every
process calls initialize_multihost() first thing, then builds one global
mesh over all devices; XLA runs the collectives without further code.
"""
from __future__ import annotations

import logging

import jax

log = logging.getLogger("rtwc_tpu")


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed when running multi-process.

    No-ops (returns False) when no coordinator is configured (argument
    or JAX_COORDINATOR_ADDRESS / COORDINATOR_ADDRESS), so single-process
    users never pay for it. Nothing discovers a cluster by itself: give
    the coordinator address, num_processes and process_id.
    """
    import os

    configured = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
        "COORDINATOR_ADDRESS"
    )
    if not configured:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        log.info(
            "multihost: process %d/%d, %d local / %d global devices",
            jax.process_index(), jax.process_count(),
            jax.local_device_count(), jax.device_count(),
        )
        return True
    except Exception as e:  # already initialized or single-process
        log.warning("jax.distributed.initialize skipped: %s", e)
        return False
