"""Camera pytree + ray generation.

Replaces Camera3D (Camera3D.h/.cpp): an FPS camera parameterized by position
and Euler rotation (pitch, yaw, roll). The reference builds a 4x4
camera-to-world matrix each frame (Camera3D.cpp:51-98), inverts it on the
CPU with a 170-line hand-expanded cofactor expansion (Camera3D.cpp:207-376),
ships it to the GPU, and each CUDA thread multiplies its view-space pixel
vector by it (RayTracing.cu:9-24). Because the basis is orthonormal the
whole dance collapses to three dot products per ray; here it is one fused,
fully differentiable jnp expression over the entire (H, W) ray grid -
differentiability w.r.t. camera extrinsics is what BASELINE's inverse-render
config needs and the reference could never do.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from rtwc_tpu.config import RenderConfig
from rtwc_tpu.mathx import normalize, pytree_dataclass


@pytree_dataclass
class Camera:
    pos: jax.Array  # [3]
    rot: jax.Array  # [3] = (pitch, yaw, roll)


def default_camera() -> Camera:
    """Reference defaults: origin, yaw = pi (Camera3D.h:62-65).
    NumPy leaves: camera state lives on the host between frames."""
    import numpy as np

    return Camera(
        pos=np.zeros((3,), np.float32),
        rot=np.array([0.0, math.pi, 0.0], np.float32),
    )


def basis(rot: jax.Array):
    """Euler-angle orthonormal basis, exact reference convention
    (Camera3D.cpp:53-75). Returns (right, up, forward), each [..., 3]."""
    p, y = rot[..., 0], rot[..., 1]
    sp, cp = jnp.sin(p), jnp.cos(p)
    sy, cy = jnp.sin(y), jnp.cos(y)
    forward = jnp.stack([-sy, -sp * cy, -cp * cy], axis=-1)
    right = jnp.stack([cy, -sp * sy, -cp * sy], axis=-1)
    up = jnp.stack([jnp.zeros_like(p), cp, -sp], axis=-1)
    return right, up, forward


def static_basis(rot: jax.Array):
    """Yaw-only movement basis (Camera3D.cpp:61-71). The reference's
    staticForward/staticRight carry a junk y/z component (y = -cos(yaw));
    replicated verbatim because Move() normalizes the full 3-vector before
    discarding y, so the junk affects the effective planar speed."""
    y = rot[..., 1]
    sy, cy = jnp.sin(y), jnp.cos(y)
    static_forward = jnp.stack([-sy, -cy, -cy], axis=-1)
    static_right = jnp.stack([cy, -sy, -sy], axis=-1)
    return static_right, static_forward


def projection_elements(config: RenderConfig):
    """The two projection-matrix entries the ray generator consumes
    (Engine3D.cpp:95-96 reads pMatrix[0][0] and [1][1], built at
    Camera3D.cpp:10-47): e = 1/tan(fov/2); aspect folds the console cell
    shape: aspect = W / (aspect_coeff * W * H) = 1 / (aspect_coeff * H)."""
    e = 1.0 / math.tan(config.fov / 2.0)
    aspect = 1.0 / (config.aspect_coeff * config.height)
    return e / aspect, e  # (element1, element2)


def camera_rays(
    camera: Camera,
    width: int,
    height: int,
    e1: float,
    e2: float,
    row_start: jax.Array | int = 0,
    n_rows: int | None = None,
):
    """Generate a (n_rows, W) grid of world-space unit ray directions.

    Pixel -> NDC follows RayTracing.cu:16-17: cx = (2*col - W)/W,
    cy = (H - 2*row)/H. View-space vector v = (cx*e1, cy*e2, 1); the
    reference transforms it with the cofactor inverse of the camera-to-world
    matrix (RayTracing.cu:20-23), which for the orthonormal basis B equals
    B^T, so world_dir = (right . v, up . v, forward . v), normalized
    (Normalize_GPU, RayTracing.cu:23).

    row_start/n_rows select a horizontal band of the image: that is the
    tile-sharding hook - each device of the mesh generates only its own
    band (row_start may be a traced value from lax.axis_index).

    Returns (origin [3], dirs [n_rows, W, 3]). Differentiable in pos/rot.
    """
    right, up, forward = basis(camera.rot)
    return camera.pos, basis_rays(right, up, forward, width, height, e1, e2,
                                  row_start, n_rows)


def basis_rays(right, up, forward, width: int, height: int, e1: float,
               e2: float, row_start: jax.Array | int = 0,
               n_rows: int | None = None) -> jax.Array:
    """camera_rays from an explicit (right, up, forward) basis: the unit
    ray directions [n_rows, W, 3] (the packed-camera kernels carry the
    basis, not the Euler angles)."""
    if n_rows is None:
        n_rows = height
    col = jnp.arange(width, dtype=jnp.float32)
    row = jnp.asarray(row_start, jnp.float32) + jnp.arange(n_rows, dtype=jnp.float32)
    cx = (2.0 * col - width) / width                    # [W]
    cy = (height - 2.0 * row) / height                  # [n_rows]
    vx = (cx * e1)[None, :]                             # [1, W]
    vy = (cy * e2)[:, None]                             # [n_rows, 1]
    # d = (right.v, up.v, forward.v) with v = (vx, vy, 1)  [B^T v], i.e.
    # d = vx*(r_x,u_x,f_x) + vy*(r_y,u_y,f_y) + (r_z,u_z,f_z).
    col0 = jnp.stack([right[..., 0], up[..., 0], forward[..., 0]], axis=-1)
    col1 = jnp.stack([right[..., 1], up[..., 1], forward[..., 1]], axis=-1)
    col2 = jnp.stack([right[..., 2], up[..., 2], forward[..., 2]], axis=-1)
    d = vx[..., None] * col0 + vy[..., None] * col1 + col2   # [n_rows, W, 3]
    return normalize(d)
