"""Fused Pallas kernel for the hard forward render (the display path).

The reference's per-pixel CUDA kernels (RayTracing.cu:170-795 +
RayTracingManager.cu:120-134 launch) as one fused Triton-route kernel:
ray generation (RayTracing.cu:9-24), the object-loop closest-hit
(RayTracing.cu:100-136 with Sphere.cu:30-68 / Plane.cu:38-73
intersections), Blinn-Phong shading (RayTracing.cu:41-79) and optional
hard shadows, writing an 8-plane framebuffer (r,g,b,depth,nx,ny,nz,
shading).

Mapping to the hardware:
  - one Triton program per power-of-two (bh, bw) ray tile - the analogue
    of the reference's 16x16 CUDA thread blocks; every per-ray quantity
    is a (bh, bw) register array;
  - per-object parameters are scalars loaded from the packed tables in
    device memory (pack.py) by dynamic index, inside a fori_loop whose
    trip count is the tile's broad-phase work-list length
    (render/tiles.py) - growing the scene never recompiles and a tile
    never pays for objects no ray of it can hit;
  - all compute is fp32 SIMT work; there is no matrix product worth the
    tensor cores at K=3.

Numerical parity with render/reference.py is required to ~1e-5 (the
golden-test strategy, SURVEY.md section 4); both derive from the same
quadratic/plane formulas.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from rtwc_tpu.camera import Camera, projection_elements
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.render.reference import Framebuffer, MISS_DISTANCE
from rtwc_tpu.render import pack as P
from rtwc_tpu.render import tiles
from rtwc_tpu.scene import Scene

# Output plane indices of the packed framebuffer.
O_R, O_G, O_B, O_DEPTH, O_NX, O_NY, O_NZ, O_SHADING = range(8)


def _pow_int(x: jax.Array, n: int) -> jax.Array:
    """x**n by repeated squaring (n = specular hardness, static)."""
    result = None
    bit = x
    while n:
        if n & 1:
            result = bit if result is None else result * bit
        n >>= 1
        if n:
            bit = bit * bit
    return result if result is not None else jnp.ones_like(x)


def _ray_kernel_body(config: RenderConfig, bh: int, bw: int, tj: int,
                     cam_ref, sph_ref, pl_ref, cnt_ref, lst_ref, out_ref):
    W, H = config.width, config.height
    e1, e2 = projection_elements(config)
    i = pl.program_id(0)
    j = pl.program_id(1)
    tile = i * tj + j

    # --- ray generation (RayTracing.cu:9-24) -------------------------------
    rowf = cam_ref[0, P.C_ROW0] + (i * bh).astype(jnp.float32) + jax.lax.broadcasted_iota(
        jnp.int32, (bh, bw), 0
    ).astype(jnp.float32)
    colf = (j * bw).astype(jnp.float32) + jax.lax.broadcasted_iota(
        jnp.int32, (bh, bw), 1
    ).astype(jnp.float32)
    cx = (2.0 * colf - W) / W
    cy = (H - 2.0 * rowf) / H
    vx = cx * e1
    vy = cy * e2

    ox = cam_ref[0, P.C_POSX]
    oy = cam_ref[0, P.C_POSY]
    oz = cam_ref[0, P.C_POSZ]
    rx, ry, rz = cam_ref[0, P.C_RX], cam_ref[0, P.C_RY], cam_ref[0, P.C_RZ]
    ux, uy, uz = cam_ref[0, P.C_UX], cam_ref[0, P.C_UY], cam_ref[0, P.C_UZ]
    fx, fy, fz = cam_ref[0, P.C_FX], cam_ref[0, P.C_FY], cam_ref[0, P.C_FZ]

    # d = (right.v, up.v, forward.v), v = (vx, vy, 1)   [B^T v]
    dx = rx * vx + ry * vy + rz
    dy = ux * vx + uy * vy + uz
    dz = fx * vx + fy * vy + fz
    inv_len = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv_len, dy * inv_len, dz * inv_len

    miss = jnp.float32(MISS_DISTANCE)
    init = (
        jnp.full((bh, bw), miss, jnp.float32),   # t_best
        jnp.zeros((bh, bw), jnp.float32),        # nx
        jnp.zeros((bh, bw), jnp.float32),        # ny
        jnp.zeros((bh, bw), jnp.float32),        # nz
        jnp.zeros((bh, bw), jnp.float32),        # col r
        jnp.zeros((bh, bw), jnp.float32),        # col g
        jnp.zeros((bh, bw), jnp.float32),        # col b
    )

    def trace_objects(o3, d3, state, hit_only: bool):
        """Closest-hit sweep over both object tables; with hit_only the
        sweep only tightens t_best (shadow rays). Primary rays loop over
        this tile's broad-phase sphere work list (exact for hard hits: an
        excluded sphere cannot intersect any tile ray); shadow rays leave
        the tile's frustum, so they sweep the full table."""
        _ox, _oy, _oz = o3
        _dx, _dy, _dz = d3

        def sphere_body(kk, st):
            k = kk if hit_only else lst_ref[tile, 1 + kk]
            t_best, snx, sny, snz, cr, cg, cb = st
            scx = sph_ref[P.S_CX, k]
            scy = sph_ref[P.S_CY, k]
            scz = sph_ref[P.S_CZ, k]
            r = sph_ref[P.S_R, k]
            # quadratic: a == 1 (unit d), b = 2 d.(o-c), c = |o-c|^2 - r^2
            ocx, ocy, ocz = _ox - scx, _oy - scy, _oz - scz
            b = 2.0 * (_dx * ocx + _dy * ocy + _dz * ocz)
            c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
            disc = b * b - 4.0 * c
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            t1 = 0.5 * (-b + sq)
            t2 = 0.5 * (-b - sq)
            valid = (disc >= 0.0) & (t1 >= 0.0) & (t2 >= 0.0)
            t = jnp.minimum(t1, t2)
            win = valid & (t < t_best)
            t_best = jnp.where(win, t, t_best)
            if hit_only:
                return (t_best, snx, sny, snz, cr, cg, cb)
            px = _ox + _dx * t - scx
            py = _oy + _dy * t - scy
            pz = _oz + _dz * t - scz
            n_inv = jax.lax.rsqrt(px * px + py * py + pz * pz)
            snx = jnp.where(win, px * n_inv, snx)
            sny = jnp.where(win, py * n_inv, sny)
            snz = jnp.where(win, pz * n_inv, snz)
            cr = jnp.where(win, sph_ref[P.S_COLR, k], cr)
            cg = jnp.where(win, sph_ref[P.S_COLG, k], cg)
            cb = jnp.where(win, sph_ref[P.S_COLB, k], cb)
            return (t_best, snx, sny, snz, cr, cg, cb)

        def plane_body(k, st):
            t_best, snx, sny, snz, cr, cg, cb = st
            pcx = pl_ref[P.P_CX, k]
            pcy = pl_ref[P.P_CY, k]
            pcz = pl_ref[P.P_CZ, k]
            pnx = pl_ref[P.P_NX, k]
            pny = pl_ref[P.P_NY, k]
            pnz = pl_ref[P.P_NZ, k]
            hw = pl_ref[P.P_HW, k]
            hh = pl_ref[P.P_HH, k]
            denom = _dx * pnx + _dy * pny + _dz * pnz
            num = (pcx - _ox) * pnx + (pcy - _oy) * pny + (pcz - _oz) * pnz
            eps = 1.1920929e-07
            safe = jnp.where(jnp.abs(denom) < eps, -1.0, denom)
            t = num / safe
            hx = _ox + _dx * t
            hz = _oz + _dz * t
            valid = (
                (denom < -eps)
                & (t > 0.0)
                & (jnp.abs(hx - pcx) < hw)
                & (jnp.abs(hz - pcz) < hh)
            )
            win = valid & (t < t_best)
            t_best = jnp.where(win, t, t_best)
            if hit_only:
                return (t_best, snx, sny, snz, cr, cg, cb)
            snx = jnp.where(win, pnx, snx)
            sny = jnp.where(win, pny, sny)
            snz = jnp.where(win, pnz, snz)
            cr = jnp.where(win, pl_ref[P.P_COLR, k], cr)
            cg = jnp.where(win, pl_ref[P.P_COLG, k], cg)
            cb = jnp.where(win, pl_ref[P.P_COLB, k], cb)
            return (t_best, snx, sny, snz, cr, cg, cb)

        n_sphere = cnt_ref[0, 0] if hit_only else lst_ref[tile, 0]
        state = jax.lax.fori_loop(0, n_sphere, sphere_body, state)
        state = jax.lax.fori_loop(0, cnt_ref[0, 1], plane_body, state)
        return state

    t_best, snx, sny, snz, cr, cg, cb = trace_objects(
        (ox, oy, oz), (dx, dy, dz), init, hit_only=False
    )

    hit = t_best < miss

    # --- Blinn-Phong shading (RayTracing.cu:41-79) -------------------------
    lx, ly, lz = config.light_pos
    px = ox + dx * t_best
    py = oy + dy * t_best
    pz = oz + dz * t_best
    ldx, ldy, ldz = lx - px, ly - py, lz - pz
    d2 = ldx * ldx + ldy * ldy + ldz * ldz
    inv_d2 = 1.0 / d2
    l_inv = jax.lax.rsqrt(jnp.maximum(d2, 1e-20))
    ldx, ldy, ldz = ldx * l_inv, ldy * l_inv, ldz * l_inv
    # view dir = -d (already unit)
    ndotl = jnp.clip(snx * ldx + sny * ldy + snz * ldz, 0.0, 1.0)

    light_vis = jnp.ones((bh, bw), jnp.float32)
    if config.shadows:
        # shadow ray from just off the surface toward the light
        sox = px + ldx * 1e-3
        soy = py + ldy * 1e-3
        soz = pz + ldz * 1e-3
        sh_state = (jnp.full((bh, bw), miss, jnp.float32),) + init[1:]
        sh_t = trace_objects((sox, soy, soz), (ldx, ldy, ldz), sh_state, hit_only=True)[0]
        dist_l = jnp.sqrt(d2)
        light_vis = jnp.where(sh_t < dist_l, 0.0, 1.0)

    hx_, hy_, hz_ = ldx - dx, ldy - dy, ldz - dz   # l + view (= -d)
    h_inv = jax.lax.rsqrt(jnp.maximum(hx_ * hx_ + hy_ * hy_ + hz_ * hz_, 1e-20))
    ndoth = jnp.clip(snx * hx_ * h_inv + sny * hy_ * h_inv + snz * hz_ * h_inv, 0.0, 1.0)
    spec_i = _pow_int(ndoth, int(config.specular_hardness))

    diff_term = config.light_diffuse_power * inv_d2 * ndotl * light_vis
    spec_term = config.light_specular_power * inv_d2 * spec_i * light_vis
    amb = config.ambient

    def shade_channel(col, light_diffuse_c, light_spec_c, obj_spec_c):
        cd = col * (1.0 / 255.0)
        s = amb * cd + diff_term * light_diffuse_c * cd + spec_term * light_spec_c * obj_spec_c
        return jnp.where(hit, jnp.minimum(255.0, s * 255.0), 0.0)

    out_ref[O_R] = shade_channel(cr, config.light_diffuse_color[0],
                                 config.light_specular_color[0], config.object_specular_color[0])
    out_ref[O_G] = shade_channel(cg, config.light_diffuse_color[1],
                                 config.light_specular_color[1], config.object_specular_color[1])
    out_ref[O_B] = shade_channel(cb, config.light_diffuse_color[2],
                                 config.light_specular_color[2], config.object_specular_color[2])
    out_ref[O_DEPTH] = t_best
    out_ref[O_NX] = jnp.where(hit, snx, 0.0)
    out_ref[O_NY] = jnp.where(hit, sny, 0.0)
    out_ref[O_NZ] = jnp.where(hit, snz, 0.0)
    out_ref[O_SHADING] = jnp.where(hit, snx, 0.0)


def _full_spec(x):
    """Whole-array block (the kernel indexes it with dynamic scalars)."""
    return pl.BlockSpec(x.shape, lambda i, j: (0,) * x.ndim)


def pallas_render_packed(sph, plane, counts, cam_vec, *, config: RenderConfig,
                         bh: int, bw: int, interpret: bool,
                         band_h: int | None = None):
    """Invoke the kernel on pre-packed tables. Call under jit.

    band_h renders only that many image rows starting at the row carried
    in cam_vec[0, C_ROW0] (NDC math still uses the full config resolution)
    - the tile-sharding hook used by dist/mesh.py. Returns the padded
    [8, Hp, Wp] plane stack."""
    Hp = tiles.round_up(band_h if band_h is not None else config.height, bh)
    Wp = tiles.round_up(config.width, bw)
    # The NDC math uses the true W/H; padded rays fall outside the image
    # and are sliced off after the call.
    grid = (Hp // bh, Wp // bw)
    kernel = functools.partial(_ray_kernel_body, config, bh, bw, grid[1])
    # Broad-phase per-tile sphere work lists (exact for hard hits).
    lists, _ = tiles.sphere_tile_lists(sph, cam_vec, config, 0.0, bh, bw,
                                       grid, hard=True)
    ins = (cam_vec, sph, plane, counts, lists)
    return pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=[_full_spec(x) for x in ins],
        out_specs=pl.BlockSpec((8, bh, bw), lambda i, j: (0, i, j)),
        out_shape=jax.ShapeDtypeStruct((8, Hp, Wp), jnp.float32),
        backend="triton",
        compiler_params=tiles.compiler_params(bh, bw),
        interpret=interpret,
        name="hard_render",
    )(*ins)


def planes_to_framebuffer(out, config: RenderConfig, height: int) -> Framebuffer:
    """Slice the padded [8, Hp, Wp] plane stack to (height, width) and
    reassemble the Framebuffer pytree."""
    out = out[:, :height, : config.width]
    rgb = jnp.moveaxis(out[O_R : O_B + 1], 0, -1)
    normal = jnp.moveaxis(out[O_NX : O_NZ + 1], 0, -1)
    depth = out[O_DEPTH]
    hit = depth <= config.far
    return Framebuffer(
        rgb=rgb,
        normal=normal,
        depth=depth,
        shading=out[O_SHADING],
        hit=hit,
        coverage=hit.astype(jnp.float32),
        alpha=hit.astype(jnp.float32),
    )


def hard_band_packed(sph, plane, counts, cam_vec, row0, *,
                     config: RenderConfig, band_h: int,
                     interpret: bool = False):
    """Render a band of `band_h` image rows starting at traced row `row0`
    on the hard forward kernel, from pre-packed tables. Returns the
    [8, Hp, Wp] plane stack (O_* indices; slice with planes_to_framebuffer).
    Used by the tile-sharded display path (dist/mesh.py)."""
    bh, bw = tiles.pick_tile(band_h, config.width)
    cam_vec = cam_vec.at[0, P.C_ROW0].set(jnp.asarray(row0, jnp.float32))
    return pallas_render_packed(
        sph, plane, counts, cam_vec,
        config=config, bh=bh, bw=bw, interpret=interpret, band_h=band_h,
    )


@functools.partial(jax.jit, static_argnames=("config", "bh", "bw", "interpret"))
def _render_pallas_jit(scene, camera, *, config: RenderConfig, bh: int, bw: int,
                       interpret: bool) -> Framebuffer:
    sph, plane, counts = P.pack_scene(scene)
    cam_vec = P.pack_camera(camera)
    out = pallas_render_packed(
        sph, plane, counts.reshape(1, 2), cam_vec,
        config=config, bh=bh, bw=bw, interpret=interpret,
    )
    return planes_to_framebuffer(out, config, config.height)


def render_frame_pallas(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    bh: int | None = None,
    bw: int | None = None,
    interpret: bool = False,
) -> Framebuffer:
    """Drop-in replacement for render_frame running the fused kernel.

    bh/bw override the power-of-two tile (tiles.pick_tile by default);
    interpret=True runs the kernel in the Pallas interpreter (CPU tests).
    """
    dbh, dbw = tiles.pick_tile(config.height, config.width)
    return _render_pallas_jit(
        scene, camera, config=config, bh=bh or dbh, bw=bw or dbw,
        interpret=interpret,
    )
