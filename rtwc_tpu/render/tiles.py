"""Tile geometry shared by the Pallas kernels: tile shapes, table padding
and the per-tile broad-phase work lists.

Both kernels (render/pallas_kernel.py, render/pallas_soft.py) run one
Triton program per (bh, bw) ray tile. Triton wants every in-kernel array
to have a power-of-two size, so tiles are powers of two and the object
axis of the packed tables is padded to one (padded slots are inactive and
never listed). The work lists are built by XLA before the kernel: a cheap
cone test per tile decides which objects can matter to any ray of the
tile, and the kernel loops only over that list - the broad phase the
reference leaves as an empty Culling stub (RayTracingManager.cu:46-51).

Every matrix product here asks for HIGHEST precision: at default
precision the GPU may run float32 products in TF32 (about three decimal
digits), and a cone test evaluated that coarsely can exclude an object it
must keep.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental.pallas import triton as pltriton

from rtwc_tpu.camera import projection_elements
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.render import pack as P
from rtwc_tpu.render.reference import _FLT_EPSILON

_HI = jax.lax.Precision.HIGHEST

# Largest tile (rows, columns) of both kernels, and rays per thread: a
# (bh, bw) tile runs on bh * bw / _RAYS_PER_THREAD threads. Every per-ray
# plane the kernel keeps live costs _RAYS_PER_THREAD registers a thread.
# (16, 32) was the fastest fused train tile swept on an H100 at 1080p/20
# and 4K/200; the display kernel's sweep could not separate the tiles
# (PERF.md).
TILE = (16, 32)
_RAYS_PER_THREAD = 4


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def pick_tile(height: int, width: int) -> tuple[int, int]:
    """Power-of-two (bh, bw) tile for an image of height x width rays:
    TILE, shrunk to the image for images smaller than one tile."""
    return min(TILE[0], next_pow2(height)), min(TILE[1], next_pow2(width))


def compiler_params(bh: int, bw: int) -> pltriton.CompilerParams:
    """Triton launch parameters for a (bh, bw) tile. The kernels' object
    loops carry data-dependent control flow, so there is nothing to
    software-pipeline: one stage."""
    warps = max(1, min(8, bh * bw // (32 * _RAYS_PER_THREAD)))
    return pltriton.CompilerParams(num_warps=warps, num_stages=1)


def pad_objects(table: jax.Array) -> jax.Array:
    """Pad the object (last) axis of a packed table with inactive zero
    columns to the next power of two (Triton's one-hot gradient rows are
    [N] vectors). Differentiable: padded columns get no gradient."""
    n = table.shape[-1]
    return jnp.pad(table, ((0, 0), (0, next_pow2(n) - n)))


def tile_cones(cam, config: RenderConfig, bh: int, bw: int, grid):
    """Per-grid-tile bounding ray cones: unit axis [Ti,Tj,3] and cos of
    the half-angle [Ti,Tj], from the tile's 4 corner rays (padded tile
    extent - conservative for edge tiles), plus the unnormalized corner
    directions d_raw [Ti,Tj,4,3]. Shared by the view-frustum and shadow
    broad phases."""
    W, H = config.width, config.height
    e1, e2 = projection_elements(config)
    Ti, Tj = grid
    row0 = cam[0, P.C_ROW0]
    r_lo = row0 + jnp.arange(Ti, dtype=jnp.float32) * bh          # [Ti]
    c_lo = jnp.arange(Tj, dtype=jnp.float32) * bw                 # [Tj]
    rr = jnp.stack([r_lo, r_lo + bh - 1.0], -1)                   # [Ti, 2]
    cc = jnp.stack([c_lo, c_lo + bw - 1.0], -1)                   # [Tj, 2]
    vy = (H - 2.0 * rr) / H * e2                                  # [Ti, 2]
    vx = (2.0 * cc - W) / W * e1                                  # [Tj, 2]
    right = cam[0, 3:6]
    up = cam[0, 6:9]
    fwd = cam[0, 9:12]
    # d = vx * right + vy * up + fwd for the 4 corner combinations
    d_raw = (vx[None, :, None, :, None] * right
             + vy[:, None, :, None, None] * up
             + fwd)                                               # [Ti,Tj,2,2,3]
    d_raw = d_raw.reshape(Ti, Tj, 4, 3)
    d = d_raw / jnp.linalg.norm(d_raw, axis=-1, keepdims=True)
    axis = jnp.sum(d, axis=2)
    axis = axis / jnp.linalg.norm(axis, axis=-1, keepdims=True)   # [Ti,Tj,3]
    cos_cone = jnp.min(jnp.einsum("tjk,tjck->tjc", axis, d, precision=_HI),
                       axis=-1)
    # d_raw is LINEAR in the NDC coords, so plane denominators d_raw.n
    # are corner-extremal - the depth-bounded shadow broad phase's plane
    # certificates build on that.
    return axis, jnp.clip(cos_cone, -1.0, 1.0), d_raw


def compact_lists(incl, sort_key=None):
    """[T, NS] inclusion mask -> int32 [T, NS+1] work-list table: column
    0 = list length, then the included indices compacted to the front
    (never overflows: the row holds all NS), ordered by sort_key
    ascending (index order when None)."""
    if sort_key is None:
        key = jnp.where(incl, 0.0, jnp.inf)
    else:
        key = jnp.where(incl, sort_key, jnp.inf)
    order = jnp.argsort(key, axis=1, stable=True)
    count = jnp.sum(incl, axis=1).astype(jnp.int32)
    return jnp.concatenate([count[:, None], order.astype(jnp.int32)], axis=1)


def sphere_tile_lists(sph, cam, config: RenderConfig, tau: float,
                      bh: int, bw: int, grid, hard: bool = False,
                      disable: bool = False, cones=None):
    """Per-tile sphere work lists: the O(N) -> O(relevant) loop upgrade.

    A cone-vs-sphere test decides, per grid tile, which spheres could
    carry softmin weight > exp(-16) relative to the ALWAYS-present
    background competitor for ANY ray of the tile.

    Exclusion is CONSERVATIVE wrt the kernel's own lb test: an excluded
    sphere satisfies lb > far + 16*tau everywhere in the tile, i.e. its
    logit trails even the background's by > 16, identical to the weight
    floor the in-kernel culling already applies.
      - geometric: a missed ray pays penalty mp * (d_perp^2 - r^2) / r^2,
        so irrelevance needs d_perp > r * sqrt(1 + (far + 16 tau)/mp)
        =: r_eff; over the tile's ray cone d_perp >= dist * sin(angle
        between the center direction and the cone, floored at 0);
      - behind/inside: the t2-penalty only guarantees irrelevance beyond
        (far + 16 tau)/mp of the origin, so anything nearer is kept.
    hard=True builds lists for the hard closest-hit kernel: no penalty
    influence, so a sphere is irrelevant exactly when no tile ray can
    geometrically hit it (r_eff = r, zero behind-origin reach).

    The list is sorted near-to-far (distance of the sphere center from
    the ray origin): likely softmin winners run first, the running max
    logit rises immediately, and the in-kernel bound then skips most of
    the tail. disable=True lists every active sphere in index order (the
    no-broad-phase baseline). Computed under stop_gradient.

    Returns (table, aux) where aux = (t_hi_sph, sky_sph), per-tile
    [Ti, Tj] inputs of the depth-bounded shadow broad phase: t_hi_sph
    bounds any INCLUDED sphere's blended-depth contribution (max of
    dist + r over the tile's list); sky_sph certifies that NO sphere
    reaches even relative weight e^-40 anywhere in the tile. aux is None
    when disable=True.
    """
    Ti, Tj = grid
    sph = jax.lax.stop_gradient(sph)
    cam = jax.lax.stop_gradient(cam)
    active = sph[P.S_ACTIVE] > 0.5
    if disable:
        incl = jnp.broadcast_to(active[None, :], (Ti * Tj, active.shape[0]))
        return compact_lists(incl), None
    mp = config.soft_miss_penalty
    reach = 0.0 if hard else (config.far + 16.0 * tau) / mp
    r_scale = 1.0 if hard else jnp.sqrt(1.0 + (config.far + 16.0 * tau) / mp)

    axis, cos_cone, _ = (cones if cones is not None
                         else tile_cones(cam, config, bh, bw, grid))
    cone = jnp.arccos(cos_cone)                                   # [Ti,Tj]

    centers = sph[P.S_CX:P.S_CZ + 1].T                            # [NS, 3]
    radius = sph[P.S_R]
    origin = cam[0, 0:3]
    v = centers - origin
    dist = jnp.linalg.norm(v, axis=-1)
    u = v / jnp.maximum(dist, 1e-12)[:, None]
    r_eff = radius * r_scale
    cosang = jnp.einsum("tjk,nk->tjn", axis, u, precision=_HI)
    ang = jnp.arccos(jnp.clip(cosang, -1.0, 1.0))                 # [Ti,Tj,NS]
    alpha = jnp.arcsin(jnp.clip(r_eff / jnp.maximum(dist, 1e-12), 0.0, 1.0))
    geom = ang <= cone[..., None] + alpha[None, None, :]
    near = dist <= r_eff + reach                                  # behind/inside
    incl3 = (geom | near[None, None, :]) & active[None, None, :]
    t_hi_sph = jnp.max(
        jnp.where(incl3, (dist + radius)[None, None, :], 0.0), axis=-1)
    # strict (e^-40) variant of the same cone test for the sky-tile
    # certificate; the margin only changes r_eff/reach.
    r_eff40 = radius * jnp.sqrt(1.0 + (config.far + 40.0 * tau) / mp)
    reach40 = (config.far + 40.0 * tau) / mp
    alpha40 = jnp.arcsin(jnp.clip(r_eff40 / jnp.maximum(dist, 1e-12),
                                  0.0, 1.0))
    incl40 = ((ang <= cone[..., None] + alpha40[None, None, :])
              | (dist <= r_eff40 + reach40)[None, None, :]) \
        & active[None, None, :]
    sky_sph = jnp.logical_not(jnp.any(incl40, axis=-1))           # [Ti,Tj]
    incl = incl3.reshape(Ti * Tj, -1)                             # [T, NS]
    key = jnp.broadcast_to(dist[None, :], incl.shape)
    return compact_lists(incl, sort_key=key), (t_hi_sph, sky_sph)


def plane_depth_bounds(pl_, cam, config: RenderConfig, tau: float, d_raw):
    """Per-tile plane-depth data for the depth-bounded shadow broad
    phase: (t_hi_planes [Ti,Tj], covered [Ti,Tj], planes_sky [Ti,Tj]).

    t_hi_planes bounds every plane's possible blended-depth contribution
    over the tile's rays; covered certifies that some plane is hit by
    EVERY ray of the tile with t_eff <= far - 16*tau, i.e. the
    background competitor is below the softmin weight floor everywhere.

    All certificates are corner-extremal and conservative:
      - the raw corner dirs d_raw are LINEAR in the NDC coords, so
        denom = d_raw.n is extremal at the tile's 4 corners; with a
        sign-consistent denom, t = num/denom (monotone in denom) and the
        hit coordinates h = o + d_raw * t_raw (linear over the convex
        plane-cone hit region) are corner-extremal too;
      - a plane is weight-irrelevant everywhere when a penalty's LINEAR
        lower bound pen(x) >= max(-x, 0) already exceeds (far + 16 tau)/mp
        at every corner: back-facing, behind, or out of bounds on one
        side, each by margin;
      - coverage uses the real softplus penalty at the corner-extremal
        worst-case constraint margins: worst t + total penalty bound
        <= far - 16 tau - 1.
    """
    eps_sign = 1e-3
    far = config.far
    mp = config.soft_miss_penalty
    k = config.soft_mask_k
    sub = (far + 16.0 * tau) / mp   # linear-penalty irrelevance margin
    active = pl_[P.P_ACTIVE] > 0.5                                # [NP]
    origin = cam[0, 0:3]
    n = pl_[P.P_NX:P.P_NZ + 1].T                                  # [NP, 3]
    pc = pl_[P.P_CX:P.P_CZ + 1].T                                 # [NP, 3]
    hw = pl_[P.P_HW]
    hh = pl_[P.P_HH]
    dn = jnp.einsum("ijck,nk->ijcn", d_raw, n, precision=_HI)     # [Ti,Tj,4,NP]
    num = jnp.sum((pc - origin[None, :]) * n, axis=-1)            # [NP]
    dnorm = jnp.linalg.norm(d_raw, axis=-1)                       # [Ti,Tj,4]
    dn_u = dn / dnorm[..., None]          # unit-dir denom (kernel scale)
    front_all = jnp.all(dn_u <= -eps_sign, axis=2)                # [Ti,Tj,NP]
    sign_ok = front_all | jnp.all(dn_u >= eps_sign, axis=2)
    safe_dn = jnp.where(jnp.abs(dn) < 1e-12, -1e-12, dn)
    t_raw = num[None, None, None, :] / safe_dn                    # [Ti,Tj,4,NP]
    t_norm = t_raw * dnorm[..., None]     # unit-dir ray parameter
    # hit coordinates at the corners (h = o + d_raw * t_raw exactly)
    ex = origin[0] + d_raw[..., 0][..., None] * t_raw - pc[None, None, None, :, 0]
    ez = origin[2] + d_raw[..., 2][..., None] * t_raw - pc[None, None, None, :, 2]
    t_in = sign_ok & jnp.all((t_norm >= 0.0) & (t_norm <= far), axis=2)

    def irrelevant_at(m):
        back_all = jnp.all(dn_u >= m, axis=2)
        behind_all = sign_ok & jnp.all(t_norm <= -m, axis=2)
        oob = front_all & t_in & (
            jnp.all(ex >= hw + m, axis=2) | jnp.all(ex <= -(hw + m), axis=2)
            | jnp.all(ez >= hh + m, axis=2) | jnp.all(ez <= -(hh + m), axis=2))
        return back_all | behind_all | oob | ~active[None, None, :]

    irrelevant = irrelevant_at(sub)
    # strict (e^-40) variant for the sky-tile certificate
    planes_sky = jnp.all(irrelevant_at((far + 40.0 * tau) / mp), axis=-1)
    t_max = jnp.max(jnp.clip(t_norm, 0.0, far), axis=2)           # [Ti,Tj,NP]
    t_hi_pl = jnp.where(irrelevant, 0.0,
                        jnp.where(front_all & t_in, t_max, far))
    t_hi_planes = jnp.max(t_hi_pl, axis=-1)                       # [Ti,Tj]

    def pen(x):
        return jnp.logaddexp(-k * x, 0.0) / k

    eps = jnp.float32(_FLT_EPSILON)
    x1 = jnp.min(-dn, axis=2) / jnp.max(dnorm, axis=2)[..., None] - eps
    x2 = jnp.min(t_norm, axis=2)
    x3 = hw[None, None, :] - jnp.max(jnp.abs(ex), axis=2)
    x4 = hh[None, None, :] - jnp.max(jnp.abs(ez), axis=2)
    pen_total = mp * (pen(x1) + pen(x2) + pen(x3) + pen(x4))
    covered = (front_all & t_in & active[None, None, :]
               & (t_max + pen_total <= far - 16.0 * tau - 1.0))
    return t_hi_planes, jnp.any(covered, axis=-1), planes_sky


def shadow_tile_lists(sph, pl_, cam, config: RenderConfig, tau: float,
                      bh: int, bw: int, grid, view_aux=None,
                      disable: bool = False, cones=None):
    """Per-tile shadow-occluder work lists: the depth-bounded light-cone
    counterpart of sphere_tile_lists.

    A ray's shadow segment runs from its blended hit point P to the
    light L. P lies on the ray at the blended depth D - a convex
    combination of per-object t_clip values and the background's far. Per
    tile, D is bounded by t_hi = max(included spheres' dist + r, planes'
    corner-extremal depth bound) + margin WHENEVER some plane provably
    covers the whole tile closer than the background weight floor
    (plane_depth_bounds). Tiles with possible sky weight keep t_hi = far.
    So P lies in the tile's view cone truncated at t_hi, and the union of
    the tile's shadow segments is conv({L} u cone(t_hi)). An occluder is
    relevant only if it comes within its smoothed radius of that hull.

    The hull distance is lower-bounded by covering the truncated cone
    with _NB balls along its axis (ball i covers the depth slab
    [i, i+1] * t_hi/_NB: radius^2 = (t_hi/2NB)^2 + (t_i tan(cone))^2), so

        dist(C, conv({L} u ball_i)) >= dist(C, seg(L, c_i)) - R_i.

    An occluder sphere is kept iff for some ball the segment distance
    minus R_i is within r * sqrt(1 + 16/ks) (sigmoid margin of the disc
    constraint) + r + 16/ks (closest-approach slack of the t2 and dist-t2
    constraints) + 0.02 (the 1e-2 self-intersection ray offset), which
    makes exclusion conservative wrt the kernel's own per-ray
    min-constraint test: every excluded sphere has block < ~1e-7 for
    EVERY ray of the tile. Plane occluders are not listed (NP is tiny;
    the kernel keeps its full plane loop). Computed under stop_gradient;
    list order is index order (transmittances multiply).
    """
    _NB = 8
    Ti, Tj = grid
    sph = jax.lax.stop_gradient(sph)
    pl_ = jax.lax.stop_gradient(pl_)
    cam = jax.lax.stop_gradient(cam)
    active = sph[P.S_ACTIVE] > 0.5
    NS = active.shape[0]
    if disable:
        incl = jnp.broadcast_to(active[None, :], (Ti * Tj, NS))
        return compact_lists(incl)
    far = config.far
    ks = config.soft_shadow_k
    light = jnp.asarray(config.light_pos, jnp.float32)
    origin = cam[0, 0:3]

    axis, cos_cone, d_raw = (cones if cones is not None
                             else tile_cones(cam, config, bh, bw, grid))
    # tan of the cone half-angle; the 0.05 floor on cos makes degenerate
    # super-wide tiles include everything instead of producing NaNs.
    tan_cone = (jnp.sqrt(jnp.maximum(1.0 - cos_cone * cos_cone, 0.0))
                / jnp.maximum(cos_cone, 0.05))                    # [Ti,Tj]

    t_hi_pl, covered, planes_sky = plane_depth_bounds(pl_, cam, config,
                                                      tau, d_raw)
    if view_aux is None:
        t_hi_sph = jnp.full((Ti, Tj), far, jnp.float32)
        sky_sph = jnp.zeros((Ti, Tj), bool)
    else:
        t_hi_sph, sky_sph = view_aux
    t_cap = jnp.where(covered, jnp.maximum(t_hi_sph, t_hi_pl) + 1.0, far)
    t_cap = jnp.clip(t_cap, 1.0, far)                             # [Ti,Tj]
    # STRICT sky tiles (no sphere above relative weight e^-40 in the view
    # cone AND every plane strictly irrelevant): light visibility cannot
    # move anything above f32 noise; the tile needs NO occluders.
    skip = sky_sph & planes_sky                                   # [Ti,Tj]

    half = t_cap / (2.0 * _NB)                                    # [Ti,Tj]
    kk = jnp.arange(_NB, dtype=jnp.float32)
    t_mid = (kk * 2.0 + 1.0) * half[..., None]                    # [Ti,Tj,NB]
    t_sl = t_mid + half[..., None]
    cb = origin + axis[..., None, :] * t_mid[..., None]           # [Ti,Tj,NB,3]
    R = jnp.sqrt(half[..., None] ** 2 + (t_sl * tan_cone[..., None]) ** 2)

    # Point-to-segment distance, segments seg(L, c_i), points = centers.
    centers = sph[P.S_CX:P.S_CZ + 1].T                            # [NS, 3]
    radius = sph[P.S_R]
    v = cb - light                                                # [Ti,Tj,NB,3]
    w = centers - light                                           # [NS, 3]
    vv = jnp.sum(v * v, -1)                                       # [Ti,Tj,NB]
    ww = jnp.sum(w * w, -1)                                       # [NS]
    wv = jnp.einsum("ijbk,nk->ijbn", v, w, precision=_HI)         # [Ti,Tj,NB,NS]
    t = jnp.clip(wv / jnp.maximum(vv, 1e-12)[..., None], 0.0, 1.0)
    d2 = ww[None, None, None, :] - 2.0 * t * wv + t * t * vv[..., None]
    d = jnp.sqrt(jnp.maximum(d2, 0.0))                            # [Ti,Tj,NB,NS]

    r_keep = radius * jnp.sqrt(1.0 + 16.0 / ks) + radius + 16.0 / ks + 0.02
    incl = jnp.any(d - R[..., None] <= r_keep[None, None, None, :], axis=2)
    incl = incl & active[None, None, :] & jnp.logical_not(skip)[..., None]
    incl = incl.reshape(Ti * Tj, NS)
    return compact_lists(incl)


def build_tile_lists(sph, pl_, cam, config: RenderConfig, tau: float,
                     bh: int, bw: int, grid, shadows: bool,
                     disable: bool = False):
    """Both broad-phase tables from ONE cone computation. Returns
    (view_table, shadow_table_or_None)."""
    cones = None if disable else tile_cones(cam, config, bh, bw, grid)
    table, aux = sphere_tile_lists(sph, cam, config, tau, bh, bw, grid,
                                   disable=disable, cones=cones)
    if not shadows:
        return table, None
    shl = shadow_tile_lists(sph, pl_, cam, config, tau, bh, bw, grid,
                            view_aux=aux, disable=disable, cones=cones)
    return table, shl
