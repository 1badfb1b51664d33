"""Dense scene / camera packing for the Pallas kernels.

The kernel consumes the scene as two small tables in device memory (each
per-object parameter is a scalar the kernel loads by dynamic index and
broadcasts against its ray tile) plus a packed camera vector. Live
objects are compacted to the front so the kernel's object loop runs
`count` iterations regardless of pool capacity - the reference's
pointer-array + count design (Object3D.h:6-12) without its
dangling-pointer hazard (Scene3D.cpp:131-164).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from rtwc_tpu.camera import Camera, basis
from rtwc_tpu.scene import Scene

# Sphere table rows (8 x NS): see _hard_kernel.
SPH_ROWS = 8
S_CX, S_CY, S_CZ, S_R, S_COLR, S_COLG, S_COLB, S_ACTIVE = range(8)
# Plane table rows (12 x NP).
PL_ROWS = 12
P_CX, P_CY, P_CZ, P_NX, P_NY, P_NZ, P_HW, P_HH, P_COLR, P_COLG, P_COLB, P_ACTIVE = range(12)
# Camera vector entries (1 x 16).
CAM_LEN = 16
(C_POSX, C_POSY, C_POSZ,
 C_RX, C_RY, C_RZ,
 C_UX, C_UY, C_UZ,
 C_FX, C_FY, C_FZ) = range(12)
# Spare camera slots the kernel wrappers fill: live-object counts as f32
# (every differentiable input of the soft kernel stays float), and the
# band's first image row (tile sharding: each device renders rows
# [row0, row0 + band_h) of the full image, dist/mesh.py).
C_NSPH, C_NPL, C_ROW0 = 12, 13, 14


def _compact(order_key: jax.Array):
    """Permutation putting active slots (key=0) before inactive (key=1),
    stable within groups."""
    return jnp.argsort(order_key, stable=True)


def pack_scene(scene: Scene):
    """Scene -> (sph [8, NS] f32, pl [12, NP] f32, counts [2] i32).

    Active objects are compacted to the front (stable order, preserving
    the reference's creation-order closest-hit tie behavior,
    RayTracing.cu:123). Jittable and differentiable (gather).
    """
    sp = scene.spheres
    perm = _compact(jnp.where(sp.active > 0.5, 0, 1))
    sph = jnp.stack(
        [
            sp.center[perm, 0], sp.center[perm, 1], sp.center[perm, 2],
            sp.radius[perm],
            sp.color[perm, 0], sp.color[perm, 1], sp.color[perm, 2],
            sp.active[perm],
        ]
    )
    pln = scene.planes
    pperm = _compact(jnp.where(pln.active > 0.5, 0, 1))
    pl = jnp.stack(
        [
            pln.center[pperm, 0], pln.center[pperm, 1], pln.center[pperm, 2],
            pln.normal[pperm, 0], pln.normal[pperm, 1], pln.normal[pperm, 2],
            pln.width[pperm] * 0.5, pln.height[pperm] * 0.5,
            pln.color[pperm, 0], pln.color[pperm, 1], pln.color[pperm, 2],
            pln.active[pperm],
        ]
    )
    counts = jnp.stack(
        [
            jnp.sum(sp.active > 0.5).astype(jnp.int32),
            jnp.sum(pln.active > 0.5).astype(jnp.int32),
        ]
    )
    return sph.astype(jnp.float32), pl.astype(jnp.float32), counts


def pack_camera(camera: Camera) -> jax.Array:
    """Camera -> [1, 16] f32: position + orthonormal basis (right, up,
    forward). Projection elements / resolution / far plane are static
    compile-time constants baked into the kernel."""
    right, up, forward = basis(camera.rot)
    vec = jnp.concatenate([camera.pos, right, up, forward, jnp.zeros((4,), jnp.float32)])
    return vec.astype(jnp.float32)[None, :]
