"""Fused one-pass soft-render MSE train kernel (Triton route).

The train step's hot path: for loss = mean(((rgb - target)/255)^2) the
output cotangents are known the moment a tile's forward finishes, so one
kernel runs, per ray tile, the soft forward render, the tile's loss and
the full backward (closed-form softmax VJP, shadow-sweep VJP, in-kernel
ray-generation VJP) with every per-ray quantity in registers. Only the
target is read from device memory, and only per-tile partial gradient
tables and scalars are written. The jnp soft renderer (render/softmin.py)
is the semantic source of truth; it writes [H, W, n_objects, 3] shading
intermediates and their autodiff residuals to device memory and culls
nothing, which is what the online softmin and the per-tile work lists
(render/tiles.py) avoid.

Structure of one program (one (bh, bw) tile):
  - forward: online softmin over the tile's sphere work list, then the
    planes (flash-attention-style running (max, sum, accumulators)).
    With shadows: a geometry pass for the blended depth, the shadow
    sweep over the tile's occluder list at the blended hit point, then
    an exact re-walk of the listed objects that blends the clamped
    colors min(255, A + vis * B) and their d(rgb)/d(vis);
  - every listed object first passes a cheap t_eff lower bound against
    the running max logit (two-level culling: broad-phase list, then a
    per-tile bound); the bound's quadratic solve is reused by the heavy
    branch;
  - backward: the per-object function is replayed under jax.vjp inside
    the kernel (scalar-parameter cotangents come back reduced over the
    tile), gated by the same bound against the final max logit;
  - outputs: per-tile partial gradient tables ([T, 8, NS], [T, 12, NP],
    object axes padded to powers of two) summed by XLA afterwards, and
    per-tile (hi, lo) two-float camera-basis partials with a compensated
    cross-tile reduce. GPU programs run in no order, so nothing is
    accumulated across programs inside the kernel.

Gradients are computed at loss-cotangent 1 and scaled in the custom_vjp
backward rule (they are exactly linear in it). Semantics match
render/softmin.py::trace_soft (same penalty formulation, same Blinn-Phong
constants, RayTracing.cu:41-79 parity) and are validated against it by
tests/test_pallas_soft.py.
"""
from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from rtwc_tpu.camera import projection_elements
from rtwc_tpu.camera.camera import basis_rays
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.render.reference import _FLT_EPSILON
from rtwc_tpu.render import pack as P
from rtwc_tpu.render import tiles
from rtwc_tpu.render.pallas_kernel import _pow_int
from rtwc_tpu.render.softmin import trace_soft
from rtwc_tpu.scene import Planes, Scene, Spheres

# Per-occluder shadow transmittance floor (softmin.py parity; see its note).
_TRANS_FLOOR = 1e-7
# Max relative softmin weight exp(-16) ~ 1e-7 of a culled object: sub-ULP.
_CULL_LOG_EPS = -16.0
# Forward shadow-sweep early-out threshold: once EVERY ray of a tile has
# vis <= this, further occluders cannot change the image (direct light
# contributes vis * B <= 1e-7 * B ~ 2e-4 worst case in the 0..255
# domain; transmittances only shrink vis), so the sweep skips their heavy
# branches. Forward value path only; the backward keeps exact gating.
_VIS_EARLY_OUT = 1e-7
# Per-tile scalar output slots: camera-vector cotangent (hi at
# [_SCAL_HI, +16), lo at [_SCAL_LO, +16)) and the tile's raw loss sum.
_SCAL_HI, _SCAL_LO, _SCAL_LOSS, _SCAL_LEN = 0, 16, 32, 64


def _softplus(x):
    # jax.nn.softplus = logaddexp(x, 0); spelled out for clean in-kernel vjp.
    return jnp.logaddexp(x, 0.0)


def _sphere_quadratic(scx, scy, scz, r, dx, dy, dz, ox, oy, oz):
    """(b, disc) of the unit-direction ray/sphere quadratic, the
    discriminant in softmin.perp_discriminant's perpendicular form
    (identical expressions, so kernel and reference round alike)."""
    ocx, ocy, ocz = ox - scx, oy - scy, oz - scz
    half_b = dx * ocx + dy * ocy + dz * ocz
    px, py, pz = ocx - half_b * dx, ocy - half_b * dy, ocz - half_b * dz
    return 2.0 * half_b, 4.0 * (r * r - (px * px + py * py + pz * pz))


def _make_object_fns(config: RenderConfig, tau: float):
    """Per-object soft intersection + shading closures, exact
    render/softmin.py semantics. All inputs scalars except the ray
    direction planes (dx, dy, dz); outputs are ray-tile planes
    (t_eff, r, g, b, t_clip, nx, ny, nz)."""
    far = config.far
    k = config.soft_mask_k
    mp = config.soft_miss_penalty
    lx, ly, lz = config.light_pos
    ldc = config.light_diffuse_color
    lsc = config.light_specular_color
    osc = config.object_specular_color
    dpow = config.light_diffuse_power
    spow = config.light_specular_power
    hard = int(config.specular_hardness)
    amb = config.ambient

    def pen(x):
        return _softplus(-k * x) / k

    def shade_terms(px, py, pz, nx, ny, nz, dx, dy, dz):
        """Color-independent Blinn-Phong terms (dterm, sterm): the only
        ray-plane-valued state shading needs. Everything per-channel is a
        scalar combination of these two planes and the object's color
        scalars (parts_from_terms)."""
        ldx, ldy, ldz = lx - px, ly - py, lz - pz
        d2 = ldx * ldx + ldy * ldy + ldz * ldz
        il = jax.lax.rsqrt(jnp.maximum(d2, 1e-20))
        inv_d2 = il * il  # 1/d^2 without the divide
        ldx, ldy, ldz = ldx * il, ldy * il, ldz * il
        # Normals arrive UNIT (sphere_geo normalizes per ray; plane_geo
        # normalizes its per-object scalars): softmin.py's in-shade
        # normalize is idempotent here, in value AND gradient (the unit-
        # sphere projection is idempotent), so the per-ray vector rsqrt
        # it would cost is dropped.
        diffuse_i = jnp.clip(nx * ldx + ny * ldy + nz * ldz, 0.0, 1.0)
        dterm = diffuse_i * dpow * inv_d2
        hx, hy, hz = ldx - dx, ldy - dy, ldz - dz
        ih = jax.lax.rsqrt(jnp.maximum(hx * hx + hy * hy + hz * hz, 1e-20))
        spec_i = jnp.clip((nx * hx + ny * hy + nz * hz) * ih, 0.0, 1.0)
        sterm = _pow_int(spec_i, hard) * spow * inv_d2
        return dterm, sterm

    def parts_from_terms(dterm, sterm, cr, cg, cb):
        def parts(col, ld_c, ls_c, os_c):
            cd = col * (1.0 / 255.0)
            return amb * cd * 255.0, (dterm * ld_c * cd + sterm * ls_c * os_c) * 255.0

        return (parts(cr, ldc[0], lsc[0], osc[0]),
                parts(cg, ldc[1], lsc[1], osc[1]),
                parts(cb, ldc[2], lsc[2], osc[2]))

    def shade_parts(cr, cg, cb, px, py, pz, nx, ny, nz, dx, dy, dz):
        # Blinn-Phong (RayTracing.cu:41-79 constants), softmin.py path:
        # view = -d (unit), light attenuates 1/d^2, ambient always on.
        # Returns the ambient and direct parts per channel in the 0..255
        # domain, so rgb_c = min(255, A_c + vis * B_c): the clamp is the
        # only nonlinearity between the parts and the output, which is what
        # lets the shadow path save d(rgb)/d(vis) as a plane.
        dterm, sterm = shade_terms(px, py, pz, nx, ny, nz, dx, dy, dz)
        return parts_from_terms(dterm, sterm, cr, cg, cb)

    def shade(cr, cg, cb, px, py, pz, nx, ny, nz, dx, dy, dz, vis=None):
        out = []
        for a_c, b_c in shade_parts(cr, cg, cb, px, py, pz, nx, ny, nz,
                                    dx, dy, dz):
            direct = b_c if vis is None else vis * b_c
            out.append(jnp.minimum(255.0, a_c + direct))
        return tuple(out)

    def sphere_lb_ex(scx, scy, scz, r, dx, dy, dz, ox, oy, oz):
        """Transcendental-free-penalty LOWER bound on the sphere's t_eff
        (pen(x) = softplus(-k x)/k >= relu(-x)): the per-tile culling
        predicate. Returns (lb, t2, dss) - the bound PLUS the quadratic
        solve's products (root t2 and the scaled discriminant
        disc/r_clamped^2), so the heavy branch behind the culling cond
        reuses them (sphere_geo_post) instead of re-solving: one solve,
        sqrt included, per relevant object (the per-thread single-solve
        structure of the reference's Sphere.cu:30-68)."""
        b, disc = _sphere_quadratic(scx, scy, scz, r, dx, dy, dz, ox, oy, oz)
        sq = jnp.sqrt(jnp.maximum(disc, 1e-12))
        t2 = 0.5 * (-b - sq)
        scale = 1.0 / jnp.maximum(r, 1e-3)
        dss = disc * scale * scale
        lb = jnp.clip(t2, 0.0, far) + mp * (
            jnp.maximum(-dss, 0.0) + jnp.maximum(-t2, 0.0))
        return lb, t2, dss

    def plane_lb_ex(pcx, pcy, pcz, pnx, pny, pnz, hw, hh, dx, dy, dz, ox, oy, oz):
        """Plane t_eff lower bound + solve products (t, denom, and the
        hit-point coordinates the bound already formed) for reuse by
        plane_geo_post behind the culling cond - deletes the divide and
        the hit-point FMAs from the heavy branch."""
        denom = dx * pnx + dy * pny + dz * pnz
        num = (pcx - ox) * pnx + (pcy - oy) * pny + (pcz - oz) * pnz
        eps = _FLT_EPSILON
        safe = jnp.where(jnp.abs(denom) < eps, -eps, denom)
        t = num / safe
        t_clip = jnp.clip(t, 0.0, far)
        px = ox + dx * t_clip
        pz = oz + dz * t_clip
        lb = t_clip + mp * (
            jnp.maximum(denom + eps, 0.0)
            + jnp.maximum(-t, 0.0)
            + jnp.maximum(jnp.abs(px - pcx) - hw, 0.0)
            + jnp.maximum(jnp.abs(pz - pcz) - hh, 0.0))
        return lb, t, denom, px, pz

    def sphere_geo(scx, scy, scz, r, dx, dy, dz, ox, oy, oz):
        """(t_eff, t_clip, normal, hit point) - shading-free intersection."""
        b, disc = _sphere_quadratic(scx, scy, scz, r, dx, dy, dz, ox, oy, oz)
        sq = jnp.sqrt(jnp.maximum(disc, 1e-12))
        t2 = 0.5 * (-b - sq)
        scale = 1.0 / jnp.maximum(r, 1e-3)
        # t1 = t2 + sq >= t2, so pen(t2) covers the reference's t1/t2 >= 0
        # pair (Sphere.cu:55-60) exactly; one softplus saved per object.
        p_ = mp * (pen(disc * scale * scale) + pen(t2))
        t_clip = jnp.clip(t2, 0.0, far)
        px = ox + dx * t_clip
        py = oy + dy * t_clip
        pz = oz + dz * t_clip
        nxr, nyr, nzr = px - scx, py - scy, pz - scz
        inn = jax.lax.rsqrt(jnp.maximum(nxr * nxr + nyr * nyr + nzr * nzr, 1e-20))
        return (t_clip + p_, t_clip,
                nxr * inn, nyr * inn, nzr * inn, px, py, pz)

    def plane_geo(pcx, pcy, pcz, pnx, pny, pnz, hw, hh, dx, dy, dz, ox, oy, oz):
        denom = dx * pnx + dy * pny + dz * pnz
        num = (pcx - ox) * pnx + (pcy - oy) * pny + (pcz - oz) * pnz
        eps = _FLT_EPSILON
        safe = jnp.where(jnp.abs(denom) < eps, -eps, denom)
        t = num / safe
        t_clip = jnp.clip(t, 0.0, far)
        px = ox + dx * t_clip
        py = oy + dy * t_clip
        pz = oz + dz * t_clip
        p_ = mp * (pen(-denom - eps) + pen(t)
                   + pen(hw - jnp.abs(px - pcx))
                   + pen(hh - jnp.abs(pz - pcz)))
        nx = pnx + 0.0 * dx   # RAW normal broadcast: softmin.py blends the
        ny = pny + 0.0 * dx   # raw plane normal into the framebuffer
        nz = pnz + 0.0 * dx   # (shading separately uses plane_unit_n)
        return t_clip + p_, t_clip, nx, ny, nz, px, py, pz

    def sphere_geo_post(scx, scy, scz, t2, dss, dx, dy, dz, ox, oy, oz):
        """sphere_geo continued from sphere_lb_ex's solve products:
        penalties, hit point and normal WITHOUT re-running the quadratic
        (same expressions as sphere_geo from t2/dss on - bit-identical).
        Forward sweeps only; the backward replays sphere_f under jax.vjp
        because the solve must be on the autodiff tape there."""
        p_ = mp * (pen(dss) + pen(t2))
        t_clip = jnp.clip(t2, 0.0, far)
        px = ox + dx * t_clip
        py = oy + dy * t_clip
        pz = oz + dz * t_clip
        nxr, nyr, nzr = px - scx, py - scy, pz - scz
        inn = jax.lax.rsqrt(jnp.maximum(nxr * nxr + nyr * nyr + nzr * nzr, 1e-20))
        return (t_clip + p_, t_clip,
                nxr * inn, nyr * inn, nzr * inn, px, py, pz)

    def plane_geo_post(pcx, pcy, pcz, pnx, pny, pnz, hw, hh, t, denom,
                       px, pz, dx, dy, dz, ox, oy, oz):
        """plane_geo continued from plane_lb_ex's solve products
        (bit-identical expressions from t/denom/px/pz on)."""
        eps = _FLT_EPSILON
        t_clip = jnp.clip(t, 0.0, far)
        py = oy + dy * t_clip
        p_ = mp * (pen(-denom - eps) + pen(t)
                   + pen(hw - jnp.abs(px - pcx))
                   + pen(hh - jnp.abs(pz - pcz)))
        nx = pnx + 0.0 * dx   # RAW normal broadcast (see plane_geo)
        ny = pny + 0.0 * dx
        nz = pnz + 0.0 * dx
        return t_clip + p_, t_clip, nx, ny, nz, px, py, pz

    def plane_unit_n(pnx, pny, pnz):
        """Unit shading normal from the per-object scalars: ONE scalar
        rsqrt per object instead of softmin.py's per-ray vector
        normalize (value- and gradient-identical: the normalize is
        idempotent and its projection jacobian is idempotent too)."""
        pn_inv = jax.lax.rsqrt(
            jnp.maximum(pnx * pnx + pny * pny + pnz * pnz, 1e-20))
        return pnx * pn_inv, pny * pn_inv, pnz * pn_inv

    def sphere_f(scx, scy, scz, r, cr, cg, cb, dx, dy, dz, ox, oy, oz,
                 vis=None):
        t_eff, t_clip, nx, ny, nz, px, py, pz = sphere_geo(
            scx, scy, scz, r, dx, dy, dz, ox, oy, oz)
        r_, g_, b_ = shade(cr, cg, cb, px, py, pz, nx, ny, nz, dx, dy, dz, vis)
        return t_eff, r_, g_, b_, t_clip, nx, ny, nz

    def plane_f(pcx, pcy, pcz, pnx, pny, pnz, hw, hh, cr, cg, cb,
                dx, dy, dz, ox, oy, oz, vis=None):
        t_eff, t_clip, nx, ny, nz, px, py, pz = plane_geo(
            pcx, pcy, pcz, pnx, pny, pnz, hw, hh, dx, dy, dz, ox, oy, oz)
        ux, uy, uz = plane_unit_n(pnx, pny, pnz)
        r_, g_, b_ = shade(cr, cg, cb, px, py, pz, ux, uy, uz, dx, dy, dz, vis)
        return t_eff, r_, g_, b_, t_clip, nx, ny, nz

    def sphere_f_post(scx, scy, scz, t2, dss, cr, cg, cb,
                      dx, dy, dz, ox, oy, oz, vis=None):
        """sphere_f continued from sphere_lb_ex's solve (culled forward
        sweeps; value-identical to sphere_f on the shared inputs)."""
        t_eff, t_clip, nx, ny, nz, px, py, pz = sphere_geo_post(
            scx, scy, scz, t2, dss, dx, dy, dz, ox, oy, oz)
        r_, g_, b_ = shade(cr, cg, cb, px, py, pz, nx, ny, nz, dx, dy, dz, vis)
        return t_eff, r_, g_, b_, t_clip, nx, ny, nz

    def plane_f_post(pcx, pcy, pcz, pnx, pny, pnz, hw, hh, t, denom, px, pz,
                     cr, cg, cb, dx, dy, dz, ox, oy, oz, vis=None):
        t_eff, t_clip, nx, ny, nz, hx, hy, hz = plane_geo_post(
            pcx, pcy, pcz, pnx, pny, pnz, hw, hh, t, denom, px, pz,
            dx, dy, dz, ox, oy, oz)
        ux, uy, uz = plane_unit_n(pnx, pny, pnz)
        r_, g_, b_ = shade(cr, cg, cb, hx, hy, hz, ux, uy, uz, dx, dy, dz, vis)
        return t_eff, r_, g_, b_, t_clip, nx, ny, nz

    # Shadow occluder transmittances (softmin.py _soft_shadow_visibility
    # parity): each hard shadow-ray reject branch is a sigmoid step, the
    # any-occluder OR a product of per-occluder transmittances, evaluated at
    # the softmin-blended hit point P. The light direction is recomputed
    # from P *inside* each closure so jax.vjp reaches every P dependency.
    ks = config.soft_shadow_k

    def _light_ray(px, py, pz):
        tlx, tly, tlz = lx - px, ly - py, lz - pz
        d2 = jnp.maximum(tlx * tlx + tly * tly + tlz * tlz, 1e-12)
        inv = jax.lax.rsqrt(d2)   # one rsqrt replaces sqrt + div
        dist = d2 * inv
        sdx, sdy, sdz = tlx * inv, tly * inv, tlz * inv
        # self-intersection offset (softmin.py uses 1e-2)
        return (sdx, sdy, sdz, dist,
                px + sdx * 1e-2, py + sdy * 1e-2, pz + sdz * 1e-2)

    def _blocked(args):
        """prod_i sigmoid(ks * a_i) via ONE division:
        prod sig(x_i) = 1 / prod(1 + exp(-x_i)) replaces n divides (one
        inside each sigmoid) with one. Exponents clamp at 20: e^20 ~ 5e8
        already makes the factor's sigmoid saturate to ~2e-9 (below f32
        noise, like the saturated sigmoid it replaces). The worst caller
        passes 5 factors (shadow_plane_f), so P can reach e^100 and
        OVERFLOW f32 (ln(f32 max) ~ 88.7) - that is safe BY CONSTRUCTION
        here, not accidental: P only overflows when >= 2 factors clamp,
        every finite prefix of the product is >= 1 (each factor >= 1),
        and 1/inf == 0 is exactly the saturated block value; in the vjp,
        d(block)/d(factor) = -block/factor has block == 0 against finite
        factors, so no inf * 0. A caller with more factors, or a higher
        clamp, must re-check both invariants: every factor >= 1, and an
        overflow only where the block value is saturated anyway."""
        P = 1.0
        for a in args:
            P = P * (1.0 + jnp.exp(jnp.minimum(-ks * a, 20.0)))
        return 1.0 / P

    def shadow_sphere_f(scx, scy, scz, r, px, py, pz):
        """Per-occluder transmittance 1 - block in [_TRANS_FLOOR, 1]."""
        sdx, sdy, sdz, dist, sox, soy, soz = _light_ray(px, py, pz)
        b, disc = _sphere_quadratic(scx, scy, scz, r, sdx, sdy, sdz,
                                    sox, soy, soz)
        sq = jnp.sqrt(jnp.maximum(disc, 1e-12))
        t1 = 0.5 * (-b + sq)
        t2 = 0.5 * (-b - sq)
        scale = 1.0 / jnp.maximum(r, 1e-3)
        block = _blocked((disc * scale * scale, t1, t2, dist - t2))
        return jnp.maximum(1.0 - block, _TRANS_FLOOR)

    def shadow_plane_f(pcx, pcy, pcz, pnx, pny, pnz, hw, hh, px, py, pz):
        sdx, sdy, sdz, dist, sox, soy, soz = _light_ray(px, py, pz)
        denom = sdx * pnx + sdy * pny + sdz * pnz
        num = (pcx - sox) * pnx + (pcy - soy) * pny + (pcz - soz) * pnz
        eps = _FLT_EPSILON
        safe = jnp.where(jnp.abs(denom) < eps, -eps, denom)
        t = num / safe
        ppx = sox + sdx * t
        ppz = soz + sdz * t
        block = _blocked((-denom - eps, t, hw - jnp.abs(ppx - pcx),
                          hh - jnp.abs(ppz - pcz), dist - t))
        return jnp.maximum(1.0 - block, _TRANS_FLOOR)

    # Split shadow evaluation for the forward sweep: the light ray depends
    # only on the (blended) hit point, so it hoists out of the object loop
    # entirely, and the per-occluder quadratic/plane solve produces BOTH
    # the culling bound (min of the constraint args) and the sigmoid
    # arguments - one solve instead of the bound+transmittance pair, with
    # only the 4 sigmoids left under the per-object cond. Exact same math
    # as shadow_*_f (which the backward replays under jax.vjp).
    def shadow_sphere_pre(scx, scy, scz, r, lr):
        sdx, sdy, sdz, dist, sox, soy, soz = lr
        b, disc = _sphere_quadratic(scx, scy, scz, r, sdx, sdy, sdz,
                                    sox, soy, soz)
        sq = jnp.sqrt(jnp.maximum(disc, 1e-12))
        t1 = 0.5 * (-b + sq)
        t2 = 0.5 * (-b - sq)
        scale = 1.0 / jnp.maximum(r, 1e-3)
        args = (disc * scale * scale, t1, t2, dist - t2)
        min_arg = jnp.minimum(jnp.minimum(args[0], args[3]),
                              jnp.minimum(t1, t2))
        return min_arg, args

    def shadow_sphere_preA(scx, scy, scz, r, lr):
        """Stage A of the split occluder gate: the quadratic WITHOUT the
        sqrt. The disc constraint (scaled discriminant dss) alone kills
        most listed-but-irrelevant occluders (the shadow ray passes wide
        of the sphere), and it needs no root - the sqrt only runs for
        occluders that survive stage A
        (shadow_sphere_preB). Bit-identical composition with
        shadow_sphere_pre."""
        sdx, sdy, sdz, dist, sox, soy, soz = lr
        b, disc = _sphere_quadratic(scx, scy, scz, r, sdx, sdy, sdz,
                                    sox, soy, soz)
        scale = 1.0 / jnp.maximum(r, 1e-3)
        dss = disc * scale * scale
        return disc, dss, b, dist

    def shadow_sphere_preB(disc, dss, b, dist):
        sq = jnp.sqrt(jnp.maximum(disc, 1e-12))
        t1 = 0.5 * (-b + sq)
        t2 = 0.5 * (-b - sq)
        args = (dss, t1, t2, dist - t2)
        min_arg = jnp.minimum(jnp.minimum(args[0], args[3]),
                              jnp.minimum(t1, t2))
        return min_arg, args

    def shadow_plane_pre(pcx, pcy, pcz, pnx, pny, pnz, hw, hh, lr):
        sdx, sdy, sdz, dist, sox, soy, soz = lr
        denom = sdx * pnx + sdy * pny + sdz * pnz
        num = (pcx - sox) * pnx + (pcy - soy) * pny + (pcz - soz) * pnz
        eps = _FLT_EPSILON
        safe = jnp.where(jnp.abs(denom) < eps, -eps, denom)
        t = num / safe
        ppx = sox + sdx * t
        ppz = soz + sdz * t
        args = (-denom - eps, t, hw - jnp.abs(ppx - pcx),
                hh - jnp.abs(ppz - pcz), dist - t)
        min_arg = jnp.minimum(jnp.minimum(args[0], args[1]),
                              jnp.minimum(jnp.minimum(args[2], args[3]),
                                          args[4]))
        return min_arg, args

    def shadow_transmittance(args):
        return jnp.maximum(1.0 - _blocked(args), _TRANS_FLOOR)

    return types.SimpleNamespace(
        sphere_f=sphere_f, plane_f=plane_f,
        sphere_f_post=sphere_f_post, plane_f_post=plane_f_post,
        sphere_lb_ex=sphere_lb_ex, plane_lb_ex=plane_lb_ex,
        sphere_geo=sphere_geo, plane_geo=plane_geo,
        sphere_geo_post=sphere_geo_post, plane_geo_post=plane_geo_post,
        plane_unit_n=plane_unit_n,
        shade_parts=shade_parts,
        shadow_sphere_f=shadow_sphere_f, shadow_plane_f=shadow_plane_f,
        light_ray=_light_ray,
        shadow_sphere_pre=shadow_sphere_pre,
        shadow_sphere_preA=shadow_sphere_preA,
        shadow_sphere_preB=shadow_sphere_preB,
        shadow_plane_pre=shadow_plane_pre,
        shadow_transmittance=shadow_transmittance,
        shadow_ks=ks,
    )


def _make_raygen(config: RenderConfig, bh: int, bw: int):
    """In-kernel ray generation as a function of the 12 camera scalars,
    exact camera/camera.py::camera_rays semantics (RayTracing.cu:9-24)."""
    W, H = config.width, config.height
    e1, e2 = projection_elements(config)

    def raygen(i, j, row0, rx, ry, rz, ux, uy, uz, fx, fy, fz):
        """(dx, dy, dz, vx, vy, inv): the rays plus the residuals the
        backward needs for the hand-written raygen VJP."""
        rowf = row0 + (i * bh).astype(jnp.float32) + jax.lax.broadcasted_iota(
            jnp.int32, (bh, bw), 0).astype(jnp.float32)
        colf = (j * bw).astype(jnp.float32) + jax.lax.broadcasted_iota(
            jnp.int32, (bh, bw), 1).astype(jnp.float32)
        vx = (2.0 * colf - W) / W * e1
        vy = (H - 2.0 * rowf) / H * e2
        dx = rx * vx + ry * vy + rz
        dy = ux * vx + uy * vy + uz
        dz = fx * vx + fy * vy + fz
        inv = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
        return dx * inv, dy * inv, dz * inv, vx, vy, inv

    return raygen


def _two_sum(a, b):
    """Knuth error-free transformation: a + b = s + err exactly."""
    s = a + b
    bv = s - a
    av = s - bv
    return s, (a - av) + (b - bv)


def _tf_combine(s1, e1, s2, e2):
    s, err = _two_sum(s1, s2)
    return s, e1 + e2 + err


def _twofloat_plane_sum(x):
    """Compensated (two-float) sum of a (bh, bw) f32 plane -> (hi, lo)
    scalars, bh and bw powers of two.

    The camera-basis cotangent sums cancel: the vx ramp is antisymmetric
    across the image, so per-ray contributions much larger than the total
    cancel, and a plain f32 reduction loses digits of it. Every combine
    here is an error-free TwoSum with the rounding error carried in a
    second float: the plane folds in halves (top/bottom, then left/right)
    until one element is left - about ten operations per element, paid
    only by the 9 camera-basis reductions per tile."""
    s, e = x, jnp.zeros_like(x)
    for axis in (0, 1):
        while s.shape[axis] > 1:
            s1, s2 = jnp.split(s, 2, axis=axis)
            e1, e2 = jnp.split(e, 2, axis=axis)
            s, e = _tf_combine(s1, e1, s2, e2)
    return s.reshape(()), e.reshape(())


def twofloat_reduce(hi, lo):
    """Compensated sum over the leading axis of (hi, lo) two-float
    partials [T, K] -> (hi, lo) [K]: a pairwise tree of error-free
    combines (XLA side, after the kernel)."""
    t = hi.shape[0]
    pad = tiles.next_pow2(t) - t
    s = jnp.pad(hi, ((0, pad), (0, 0)))
    e = jnp.pad(lo, ((0, pad), (0, 0)))
    while s.shape[0] > 1:
        h = s.shape[0] // 2
        s, e = _tf_combine(s[:h], e[:h], s[h:], e[h:])
    return s[0], e[0]


def _load_sphere(sph_ref, k):
    return (sph_ref[P.S_CX, k], sph_ref[P.S_CY, k], sph_ref[P.S_CZ, k],
            sph_ref[P.S_R, k])


def _load_sphere_color(sph_ref, k):
    return sph_ref[P.S_COLR, k], sph_ref[P.S_COLG, k], sph_ref[P.S_COLB, k]


def _load_plane(pl_ref, k):
    return (pl_ref[P.P_CX, k], pl_ref[P.P_CY, k], pl_ref[P.P_CZ, k],
            pl_ref[P.P_NX, k], pl_ref[P.P_NY, k], pl_ref[P.P_NZ, k],
            pl_ref[P.P_HW, k], pl_ref[P.P_HH, k])


def _load_plane_color(pl_ref, k):
    return pl_ref[P.P_COLR, k], pl_ref[P.P_COLG, k], pl_ref[P.P_COLB, k]


def _shadow_vis_sweep(fns, cull, bh, bw, sph_ref, pl_ref, shlst_ref, tile,
                      n_pl, lr):
    """Light-visibility product over the tile's shadow work list and the
    planes. Two-level occluder culling: the sphere loop runs over the
    light-cone broad-phase list (tiles.shadow_tile_lists), and one solve
    per listed occluder yields both the per-ray constraint bound and the
    sigmoid arguments; occluders whose min constraint stays below -16/ks
    everywhere block < ~1e-7 and skip the 4-sigmoid transmittance. The
    sphere gate has two stages: the sqrt-free disc constraint first, the
    root and the remaining constraints only for survivors. The loops
    also carry an all-dark flag: once every ray of the tile has vis <=
    _VIS_EARLY_OUT, remaining occluders skip their heavy branch (the flag
    is refreshed only inside the heavy branch, so lit tiles pay nothing).
    cull=False runs the exact sweeps (the no-culling baseline)."""
    rel_floor = -16.0 / fns.shadow_ks

    def apply(c, args):
        v, _ = c
        v = v * fns.shadow_transmittance(args)
        return v, jnp.max(v) <= _VIS_EARLY_OUT

    def sphere_step(jj, carry):
        geo = _load_sphere(sph_ref, shlst_ref[tile, 1 + jj])
        if not cull:
            return apply(carry, fns.shadow_sphere_pre(*geo, lr)[1])
        disc, dss, b, dist = fns.shadow_sphere_preA(*geo, lr)

        def stage_b(c):
            min_arg, args = fns.shadow_sphere_preB(disc, dss, b, dist)
            rel = (jnp.max(min_arg) > rel_floor) & jnp.logical_not(c[1])
            return jax.lax.cond(rel, lambda cc: apply(cc, args),
                                lambda cc: cc, c)

        return jax.lax.cond(jnp.max(dss) > rel_floor, stage_b,
                            lambda c: c, carry)

    def plane_step(k, carry):
        min_arg, args = fns.shadow_plane_pre(*_load_plane(pl_ref, k), lr)
        if not cull:
            return apply(carry, args)
        rel = (jnp.max(min_arg) > rel_floor) & jnp.logical_not(carry[1])
        return jax.lax.cond(rel, lambda c: apply(c, args), lambda c: c,
                            carry)

    carry = (jnp.ones((bh, bw), jnp.float32), jnp.zeros((), jnp.bool_))
    # PLANES FIRST (the transmittance product commutes): the few plane
    # occluders are the likely full blockers (a roof/slab), so running
    # them first lets the all-dark flag skip the whole sphere list.
    carry = jax.lax.fori_loop(0, n_pl, plane_step, carry)
    vis, _ = jax.lax.fori_loop(0, shlst_ref[tile, 0], sphere_step, carry)
    return vis


def _clamp_blend(fns, cull, sph_ref, pl_ref, lst_ref, tile, n_pl, m, inv_s,
                 inv_tau, vis, dx, dy, dz, ox, oy, oz, zero):
    """Exact clamped color blend of the shadowed forward: re-walk the
    tile's objects, gated by the culling bound against the FINAL max
    logit m, re-deriving each object's shading parts and accumulating
    w * min(255, A + vis * B) and d(rgb)/d(vis) = w * B * [A + vis B <
    255]. Returns (r, g, b, dvis_r, dvis_g, dvis_b), normalized."""
    def shade_accumulate(carry, t_eff, col, point, normal):
        w = jnp.exp(-t_eff * inv_tau - m) * inv_s
        parts = fns.shade_parts(*col, *point, *normal, dx, dy, dz)
        out = list(carry)
        for c in range(3):
            a_c, b_c = parts[c]
            val = a_c + vis * b_c
            out[c] = carry[c] + w * jnp.minimum(255.0, val)
            out[3 + c] = carry[3 + c] + w * jnp.where(val < 255.0, b_c, 0.0)
        return tuple(out)

    def sphere_body(jj, carry):
        k = lst_ref[tile, 1 + jj]
        geo = _load_sphere(sph_ref, k)
        col = _load_sphere_color(sph_ref, k)
        if not cull:
            t_eff, _, nx, ny, nz, hx, hy, hz = fns.sphere_geo(
                *geo, dx, dy, dz, ox, oy, oz)
            return shade_accumulate(carry, t_eff, col, (hx, hy, hz),
                                    (nx, ny, nz))
        lb, t2, dss = fns.sphere_lb_ex(*geo, dx, dy, dz, ox, oy, oz)

        def heavy(c):
            t_eff, _, nx, ny, nz, hx, hy, hz = fns.sphere_geo_post(
                geo[0], geo[1], geo[2], t2, dss, dx, dy, dz, ox, oy, oz)
            return shade_accumulate(c, t_eff, col, (hx, hy, hz), (nx, ny, nz))

        rel = jnp.max(-lb * inv_tau - m) > _CULL_LOG_EPS
        return jax.lax.cond(rel, heavy, lambda c: c, carry)

    def plane_body(k, carry):
        geo = _load_plane(pl_ref, k)
        col = _load_plane_color(pl_ref, k)
        unit_n = fns.plane_unit_n(*geo[3:6])
        if not cull:
            t_eff, _, _, _, _, hx, hy, hz = fns.plane_geo(
                *geo, dx, dy, dz, ox, oy, oz)
            return shade_accumulate(carry, t_eff, col, (hx, hy, hz), unit_n)
        lb, t, denom, pxp, pzp = fns.plane_lb_ex(*geo, dx, dy, dz, ox, oy, oz)

        def heavy(c):
            t_eff, _, _, _, _, hx, hy, hz = fns.plane_geo_post(
                *geo, t, denom, pxp, pzp, dx, dy, dz, ox, oy, oz)
            return shade_accumulate(c, t_eff, col, (hx, hy, hz), unit_n)

        rel = jnp.max(-lb * inv_tau - m) > _CULL_LOG_EPS
        return jax.lax.cond(rel, heavy, lambda c: c, carry)

    out = jax.lax.fori_loop(0, lst_ref[tile, 0], sphere_body, (zero,) * 6)
    return jax.lax.fori_loop(0, n_pl, plane_body, out)


def _soft_mse_fused_body(config: RenderConfig, tau: float, bh: int, bw: int,
                         tj: int, cull: bool, band_h: int | None, *refs):
    """One tile of the one-pass fused MSE train kernel (module docstring).

    Outputs, per tile t: dsph [t, 8, NS] and dpl [t, 12, NP] (table
    cotangents at loss-cotangent 1), scal [t, 64] (camera-vector
    cotangent as two-float hi/lo slots and the raw loss sum of
    ((rgb - target)/255)^2; the wrapper divides by 3*H*W)."""
    if config.shadows:
        (cam_ref, sph_ref, pl_ref, lst_ref, shlst_ref, tgt_ref,
         dsph_ref, dpl_ref, scal_ref) = refs
    else:
        (cam_ref, sph_ref, pl_ref, lst_ref, tgt_ref,
         dsph_ref, dpl_ref, scal_ref) = refs
    fns = _make_object_fns(config, tau)
    raygen = _make_raygen(config, bh, bw)
    i, j = pl.program_id(0), pl.program_id(1)
    tile = i * tj + j
    NS = sph_ref.shape[1]
    NP = pl_ref.shape[1]

    ox, oy, oz = cam_ref[0, 0], cam_ref[0, 1], cam_ref[0, 2]
    cam9 = tuple(cam_ref[0, idx] for idx in range(3, 12))
    row0 = cam_ref[0, P.C_ROW0]
    dx, dy, dz, vxp, vyp, rinv = raygen(i, j, row0, *cam9)

    inv_tau = 1.0 / tau
    bg_logit = -config.far / tau
    n_pl = cam_ref[0, P.C_NPL].astype(jnp.int32)
    zero = jnp.zeros((bh, bw), jnp.float32)
    sph_iota = jax.lax.broadcasted_iota(jnp.int32, (NS,), 0)
    pl_iota = jax.lax.broadcasted_iota(jnp.int32, (NP,), 0)

    # ================= forward =================
    def blend(state, logit, vals):
        """Online softmin update: of alpha = exp(m - m_new) and
        p = exp(logit - m_new) one is always 1, so a single exp of
        -|logit - m| serves both."""
        m, s, acc = state
        e = jnp.exp(-jnp.abs(logit - m))
        up = logit > m
        alpha_ = jnp.where(up, e, 1.0)
        pw = jnp.where(up, 1.0, e)
        acc = tuple(a * alpha_ + pw * v for a, v in zip(acc, vals))
        return jnp.maximum(m, logit), s * alpha_ + pw, acc

    def forward_sweep(shaded, acc0):
        """Softmin over the tile's sphere list, then the planes. shaded
        blends the clamped rgb (unshadowed forward); otherwise the depth
        t_clip only (the shadowed geometry pass)."""
        pick = (lambda v: v[1:4]) if shaded else (lambda v: v[1:2])

        def sphere_body(jj, st):
            k = lst_ref[tile, 1 + jj]
            geo, col = _load_sphere(sph_ref, k), _load_sphere_color(sph_ref, k)
            if not cull:
                v = (fns.sphere_f(*geo, *col, dx, dy, dz, ox, oy, oz)
                     if shaded else fns.sphere_geo(*geo, dx, dy, dz,
                                                   ox, oy, oz))
                return blend(st, -v[0] * inv_tau, pick(v))
            lb, t2, dss = fns.sphere_lb_ex(*geo, dx, dy, dz, ox, oy, oz)

            def heavy(s):
                post = geo[:3] + (t2, dss)
                v = (fns.sphere_f_post(*post, *col, dx, dy, dz, ox, oy, oz)
                     if shaded else fns.sphere_geo_post(*post, dx, dy, dz,
                                                        ox, oy, oz))
                return blend(s, -v[0] * inv_tau, pick(v))

            rel = jnp.max(-lb * inv_tau - st[0]) > _CULL_LOG_EPS
            return jax.lax.cond(rel, heavy, lambda s: s, st)

        def plane_body(k, st):
            geo, col = _load_plane(pl_ref, k), _load_plane_color(pl_ref, k)
            if not cull:
                v = (fns.plane_f(*geo, *col, dx, dy, dz, ox, oy, oz)
                     if shaded else fns.plane_geo(*geo, dx, dy, dz,
                                                  ox, oy, oz))
                return blend(st, -v[0] * inv_tau, pick(v))
            lb, t, denom, pxp, pzp = fns.plane_lb_ex(*geo, dx, dy, dz,
                                                     ox, oy, oz)

            def heavy(s):
                post = geo + (t, denom, pxp, pzp)
                v = (fns.plane_f_post(*post, *col, dx, dy, dz, ox, oy, oz)
                     if shaded else fns.plane_geo_post(*post, dx, dy, dz,
                                                       ox, oy, oz))
                return blend(s, -v[0] * inv_tau, pick(v))

            rel = jnp.max(-lb * inv_tau - st[0]) > _CULL_LOG_EPS
            return jax.lax.cond(rel, heavy, lambda s: s, st)

        # The background competitor seeds the state (logit -far/tau).
        state = (jnp.full((bh, bw), bg_logit, jnp.float32),
                 jnp.ones((bh, bw), jnp.float32), acc0)
        state = jax.lax.fori_loop(0, lst_ref[tile, 0], sphere_body, state)
        return jax.lax.fori_loop(0, n_pl, plane_body, state)

    if config.shadows:
        m, s, (acc_depth,) = forward_sweep(
            False, (jnp.full((bh, bw), config.far, jnp.float32),))
        inv_s = 1.0 / s
        out_depth = acc_depth * inv_s
        px_b = ox + dx * out_depth
        py_b = oy + dy * out_depth
        pz_b = oz + dz * out_depth
        lr = fns.light_ray(px_b, py_b, pz_b)
        vis = _shadow_vis_sweep(fns, cull, bh, bw, sph_ref, pl_ref,
                                shlst_ref, tile, n_pl, lr)
        rgb_dv = _clamp_blend(fns, cull, sph_ref, pl_ref, lst_ref, tile,
                              n_pl, m, inv_s, inv_tau, vis,
                              dx, dy, dz, ox, oy, oz, zero)
        out_rgb, dv = rgb_dv[:3], rgb_dv[3:]
    else:
        m, s, acc = forward_sweep(True, (zero,) * 3)
        inv_s = 1.0 / s
        out_rgb = tuple(a * inv_s for a in acc)

    # ================= loss + cotangents (gbar = 1) =================
    H = band_h if band_h is not None else config.height
    W = config.width
    rows = i * bh + jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 0)
    cols = j * bw + jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 1)
    mask = ((rows < H) & (cols < W)).astype(jnp.float32)
    diff = tuple((out_rgb[c] - tgt_ref[c]) * mask for c in range(3))
    tile_loss = (jnp.sum(diff[0] * diff[0]) + jnp.sum(diff[1] * diff[1])
                 + jnp.sum(diff[2] * diff[2])) * (1.0 / 255.0 ** 2)
    scale = 2.0 / (255.0 * 255.0 * 3.0 * H * W)
    g_rgb = tuple(scale * d for d in diff)
    no_sph = tuple(jnp.zeros((NS,), jnp.float32) for _ in range(P.SPH_ROWS))
    no_pl = tuple(jnp.zeros((NP,), jnp.float32) for _ in range(P.PL_ROWS))

    # ================= backward =================
    if config.shadows:
        g_vis = g_rgb[0] * dv[0] + g_rgb[1] * dv[1] + g_rgb[2] * dv[2]
        rel_floor = -16.0 / fns.shadow_ks

        def sh_sphere_body(jj, carry):
            k = shlst_ref[tile, 1 + jj]
            geo = _load_sphere(sph_ref, k)

            def heavy(c):
                ctx, cty, ctz, dsph, dpl = c
                f_j, fvjp = jax.vjp(fns.shadow_sphere_f, *geo, px_b, py_b, pz_b)
                grads = fvjp(g_vis * vis / f_j)
                onehot = (sph_iota == k).astype(jnp.float32)
                dsph = tuple((a + onehot * grads[row]) if row < 4 else a
                             for row, a in enumerate(dsph))
                return (ctx + grads[4], cty + grads[5], ctz + grads[6],
                        dsph, dpl)

            if not cull:
                return heavy(carry)
            # the forward sweep's geometric gate (pre-darkness), recomputed
            disc, dss, b, dist = fns.shadow_sphere_preA(*geo, lr)

            def stage_b(c):
                min_arg, _ = fns.shadow_sphere_preB(disc, dss, b, dist)
                return jax.lax.cond(jnp.max(min_arg) > rel_floor, heavy,
                                    lambda cc: cc, c)

            return jax.lax.cond(jnp.max(dss) > rel_floor, stage_b,
                                lambda c: c, carry)

        def sh_plane_body(k, carry):
            geo = _load_plane(pl_ref, k)

            def heavy(c):
                ctx, cty, ctz, dsph, dpl = c
                f_j, fvjp = jax.vjp(fns.shadow_plane_f, *geo, px_b, py_b, pz_b)
                grads = fvjp(g_vis * vis / f_j)
                onehot = (pl_iota == k).astype(jnp.float32)
                dpl = tuple((a + onehot * grads[row]) if row < 8 else a
                            for row, a in enumerate(dpl))
                return (ctx + grads[8], cty + grads[9], ctz + grads[10],
                        dsph, dpl)

            if not cull:
                return heavy(carry)
            min_arg, _ = fns.shadow_plane_pre(*geo, lr)
            return jax.lax.cond(jnp.max(min_arg) > rel_floor, heavy,
                                lambda c: c, carry)

        sh_carry = jax.lax.fori_loop(0, shlst_ref[tile, 0], sh_sphere_body,
                                     (zero, zero, zero, no_sph, no_pl))
        ct_px, ct_py, ct_pz, dsph0, dpl0 = jax.lax.fori_loop(
            0, n_pl, sh_plane_body, sh_carry)

        # P = o + d * depth: the shadow cotangent reaches the blended
        # depth (g_depth), the ray directions and the camera origin.
        g_depth = ct_px * dx + ct_py * dy + ct_pz * dz
        S = (g_rgb[0] * out_rgb[0] + g_rgb[1] * out_rgb[1]
             + g_rgb[2] * out_rgb[2] + g_depth * out_depth)
        vis_kw = {"vis": vis}
        seed = (ct_px * out_depth, ct_py * out_depth, ct_pz * out_depth,
                jnp.sum(ct_px), jnp.sum(ct_py), jnp.sum(ct_pz), dsph0, dpl0)
    else:
        g_depth = zero
        S = (g_rgb[0] * out_rgb[0] + g_rgb[1] * out_rgb[1]
             + g_rgb[2] * out_rgb[2])
        vis_kw = {}
        z0 = jnp.zeros((), jnp.float32)
        seed = (zero, zero, zero, z0, z0, z0, no_sph, no_pl)

    def cotangents(vals):
        """Closed-form softmax VJP: dL/dlogit_k = w_k (g.v_k - S)."""
        t_eff, r_, g_, b_, t_clip = vals[:5]
        w = jnp.exp(-t_eff * inv_tau - m) * inv_s
        gdotv = (g_rgb[0] * r_ + g_rgb[1] * g_ + g_rgb[2] * b_
                 + g_depth * t_clip)
        ct_teff = -w * (gdotv - S) * inv_tau
        # Normal cotangents are zero for the rgb MSE; the zero plane (a
        # compile-time constant) const-folds out of the vjp.
        return (ct_teff, w * g_rgb[0], w * g_rgb[1], w * g_rgb[2],
                w * g_depth, zero, zero, zero)

    def sphere_body(jj, carry):
        k = lst_ref[tile, 1 + jj]
        geo = _load_sphere(sph_ref, k)

        def heavy(c):
            gdx, gdy, gdz, gox, goy, goz, dsph, dpl = c
            args = (*geo, *_load_sphere_color(sph_ref, k),
                    dx, dy, dz, ox, oy, oz)
            vals, fvjp = jax.vjp(lambda *a: fns.sphere_f(*a, **vis_kw), *args)
            grads = fvjp(cotangents(vals))
            onehot = (sph_iota == k).astype(jnp.float32)
            dsph = tuple((a + onehot * grads[row]) if row < 7 else a
                         for row, a in enumerate(dsph))
            return (gdx + grads[7], gdy + grads[8], gdz + grads[9],
                    gox + grads[10], goy + grads[11], goz + grads[12],
                    dsph, dpl)

        if not cull:
            return heavy(carry)
        lb = fns.sphere_lb_ex(*geo, dx, dy, dz, ox, oy, oz)[0]
        rel = jnp.max(-lb * inv_tau - m) > _CULL_LOG_EPS
        return jax.lax.cond(rel, heavy, lambda c: c, carry)

    def plane_body(k, carry):
        geo = _load_plane(pl_ref, k)

        def heavy(c):
            gdx, gdy, gdz, gox, goy, goz, dsph, dpl = c
            args = (*geo, *_load_plane_color(pl_ref, k),
                    dx, dy, dz, ox, oy, oz)
            vals, fvjp = jax.vjp(lambda *a: fns.plane_f(*a, **vis_kw), *args)
            grads = fvjp(cotangents(vals))
            onehot = (pl_iota == k).astype(jnp.float32)
            dpl = tuple((a + onehot * grads[row]) if row < 11 else a
                        for row, a in enumerate(dpl))
            return (gdx + grads[11], gdy + grads[12], gdz + grads[13],
                    gox + grads[14], goy + grads[15], goz + grads[16],
                    dsph, dpl)

        if not cull:
            return heavy(carry)
        lb = fns.plane_lb_ex(*geo, dx, dy, dz, ox, oy, oz)[0]
        rel = jnp.max(-lb * inv_tau - m) > _CULL_LOG_EPS
        return jax.lax.cond(rel, heavy, lambda c: c, carry)

    carry = jax.lax.fori_loop(0, lst_ref[tile, 0], sphere_body, seed)
    gdx, gdy, gdz, gox, goy, goz, dsph_rows, dpl_rows = jax.lax.fori_loop(
        0, n_pl, plane_body, carry)

    for row, vec in enumerate(dsph_rows):
        dsph_ref[0, row, :] = vec
    for row, vec in enumerate(dpl_rows):
        dpl_ref[0, row, :] = vec

    # Ray-generation VJP: d = normalize(B^T (vx, vy, 1)); the camera
    # basis cotangents are plane sums of gp * (vx, vy, 1).
    sd = gdx * dx + gdy * dy + gdz * dz
    gps = (rinv * (gdx - dx * sd),
           rinv * (gdy - dy * sd),
           rinv * (gdz - dz * sd))
    slots = [(_SCAL_HI + P.C_POSX, gox), (_SCAL_HI + P.C_POSY, goy),
             (_SCAL_HI + P.C_POSZ, goz), (_SCAL_LOSS, tile_loss)]
    for c, gp in enumerate(gps):
        for kk, wplane in enumerate((vxp, vyp, None)):
            hi, lo = _twofloat_plane_sum(gp if wplane is None else gp * wplane)
            slots += [(_SCAL_HI + 3 + 3 * c + kk, hi),
                      (_SCAL_LO + 3 + 3 * c + kk, lo)]
    # One vector store writes every slot (unused ones zero): GPU outputs
    # start uninitialized.
    slot_iota = jax.lax.broadcasted_iota(jnp.int32, (_SCAL_LEN,), 0)
    scal = jnp.zeros((_SCAL_LEN,), jnp.float32)
    for idx, val in slots:
        scal = jnp.where(slot_iota == idx, val, scal)
    scal_ref[0, :] = scal


def _tables_scene(sph, pl_) -> Scene:
    """Packed tables -> a Scene pytree for the jnp renderer (pack.py
    layout; animation fields zero)."""
    ns, npl = sph.shape[1], pl_.shape[1]
    return Scene(
        spheres=Spheres(
            center=sph[P.S_CX:P.S_CZ + 1].T, radius=sph[P.S_R],
            color=sph[P.S_COLR:P.S_COLB + 1].T,
            speed=jnp.zeros((ns,), jnp.float32),
            mover=jnp.zeros((ns,), jnp.float32), active=sph[P.S_ACTIVE]),
        planes=Planes(
            center=pl_[P.P_CX:P.P_CZ + 1].T, normal=pl_[P.P_NX:P.P_NZ + 1].T,
            color=pl_[P.P_COLR:P.P_COLB + 1].T, width=2.0 * pl_[P.P_HW],
            height=2.0 * pl_[P.P_HH], active=pl_[P.P_ACTIVE]))


def _jnp_band_rgb(sph, pl_, cam, config: RenderConfig, tau: float,
                  band_h: int):
    """The band's soft rgb [band_h, W, 3] from the jnp renderer, on the
    kernel's inputs (packed tables, camera vector with C_ROW0)."""
    e1, e2 = projection_elements(config)
    dirs = basis_rays(cam[0, 3:6], cam[0, 6:9], cam[0, 9:12], config.width,
                      config.height, e1, e2, row_start=cam[0, P.C_ROW0],
                      n_rows=band_h)
    return trace_soft(_tables_scene(sph, pl_), cam[0, 0:3], dirs, config,
                      tau=tau)[0]


def _full_spec(x):
    """Whole-array block (the kernel indexes it with dynamic scalars)."""
    return pl.BlockSpec(x.shape, lambda i, j: (0,) * x.ndim)


@functools.lru_cache(maxsize=32)
def _build_fused_mse(config: RenderConfig, tau: float, bh: int, bw: int,
                     interpret: bool, band_h: int | None = None,
                     cull: bool = True):
    """custom_vjp'd fn(sph [8,NS], pl [12,NP], cam [1,16], tgt [3,Hp,Wp])
    -> mean(((rgb - tgt)/255)^2) over the valid pixels of the band (or
    image). NS and NP must be powers of two (tiles.pad_objects).

    The forward rule runs the one-pass kernel at loss-cotangent 1; the
    backward rule scales its gradient tables by the caller's gbar. An
    un-differentiated call, and the target's cotangent, take the jnp
    forward instead (no kernel, no gradient work). cull=False disables
    the two-level culling (the no-culling baseline the tests compare
    with)."""
    Hv = band_h if band_h is not None else config.height
    Wv = config.width
    Hp = tiles.round_up(Hv, bh)
    Wp = tiles.round_up(Wv, bw)
    grid = (Hp // bh, Wp // bw)
    T = grid[0] * grid[1]
    inv_n = 1.0 / (3.0 * Hv * Wv)
    kernel = functools.partial(_soft_mse_fused_body, config, tau, bh, bw,
                               grid[1], cull, band_h)

    def per_tile(i, j):
        return (i * grid[1] + j, 0, 0)

    def fused_call(sph, pl_, cam, tgt):
        lists, shl = tiles.build_tile_lists(sph, pl_, cam, config, tau, bh,
                                            bw, grid, config.shadows,
                                            disable=not cull)
        ins = [cam, sph, pl_, lists] + ([shl] if config.shadows else [])
        ns, npl = sph.shape[1], pl_.shape[1]
        dsph_t, dpl_t, scal_t = pl.pallas_call(
            kernel,
            grid=grid,
            in_specs=[_full_spec(x) for x in ins]
            + [pl.BlockSpec((3, bh, bw), lambda i, j: (0, i, j))],
            out_specs=[
                pl.BlockSpec((1, P.SPH_ROWS, ns), per_tile),
                pl.BlockSpec((1, P.PL_ROWS, npl), per_tile),
                pl.BlockSpec((1, _SCAL_LEN), lambda i, j: per_tile(i, j)[:2]),
            ],
            out_shape=[
                jax.ShapeDtypeStruct((T, P.SPH_ROWS, ns), jnp.float32),
                jax.ShapeDtypeStruct((T, P.PL_ROWS, npl), jnp.float32),
                jax.ShapeDtypeStruct((T, _SCAL_LEN), jnp.float32),
            ],
            backend="triton",
            compiler_params=tiles.compiler_params(bh, bw),
            interpret=interpret,
            name="soft_mse_fused",
        )(*ins, tgt)
        hi, lo = twofloat_reduce(scal_t[:, _SCAL_HI:_SCAL_HI + P.CAM_LEN],
                                 scal_t[:, _SCAL_LO:_SCAL_LO + P.CAM_LEN])
        loss = jnp.sum(scal_t[:, _SCAL_LOSS]) * inv_n
        return (loss, jnp.sum(dsph_t, axis=0), jnp.sum(dpl_t, axis=0),
                (hi + lo)[None, :])

    def jnp_rgb(sph, pl_, cam):
        rgb = _jnp_band_rgb(sph, pl_, cam, config, tau, Hv)
        return jnp.moveaxis(rgb, -1, 0)                          # [3, Hv, W]

    @jax.custom_vjp
    def soft_mse(sph, pl_, cam, tgt):
        rgb = jnp_rgb(sph, pl_, cam)
        return jnp.mean(((rgb - tgt[:, :Hv, :Wv]) / 255.0) ** 2)

    def mse_fwd(sph, pl_, cam, tgt):
        loss, dsph, dpl, dcam = fused_call(sph, pl_, cam, tgt)
        return loss, (dsph, dpl, dcam, sph, pl_, cam, tgt)

    def mse_bwd(res, gbar):
        dsph, dpl, dcam, sph, pl_, cam, tgt = res
        g = jnp.asarray(gbar, jnp.float32)
        # Target cotangent: needs the rgb planes the fused kernel never
        # materializes, so it takes the jnp forward. XLA drops this whole
        # branch when, as in every train loop, the target is not
        # differentiated.
        rgb = jnp_rgb(sph, pl_, cam)
        gt = -g * 2.0 * inv_n / (255.0 * 255.0) * (rgb - tgt[:, :Hv, :Wv])
        dtgt = jnp.zeros_like(tgt).at[:, :Hv, :Wv].set(gt)
        return g * dsph, g * dpl, g * dcam, dtgt

    soft_mse.defvjp(mse_fwd, mse_bwd)
    return soft_mse, (Hp, Wp)


def _pack_for_kernel(sph, pl_, counts, cam):
    """Pad the object axes to powers of two and put the live counts in
    the camera vector's spare slots."""
    cam = cam.at[0, P.C_NSPH].set(counts[0].astype(jnp.float32))
    cam = cam.at[0, P.C_NPL].set(counts[1].astype(jnp.float32))
    return tiles.pad_objects(sph), tiles.pad_objects(pl_), cam


def _target_planes(target, Hp: int, Wp: int):
    """[h, w, 3] target -> the kernel's zero-padded [3, Hp, Wp] layout."""
    tgt = jnp.moveaxis(target.astype(jnp.float32), -1, 0)
    return jnp.pad(tgt, ((0, 0), (0, Hp - tgt.shape[1]),
                         (0, Wp - tgt.shape[2])))


def soft_band_mse_loss(sph, pl_, counts, cam, row0, tgt_band, *,
                       config: RenderConfig, tau: float, band_h: int,
                       interpret: bool = False):
    """Fused-MSE loss of a band of `band_h` image rows starting at traced
    row `row0`, from pack.py tables: mean(((rgb - tgt_band)/255)^2) over
    the band, tgt_band [band_h, W, 3]. Used by the tile-sharded train
    step (dist/mesh.py): per-band means pmean to the global mean."""
    bh, bw = tiles.pick_tile(band_h, config.width)
    sph, pl_, cam = _pack_for_kernel(sph, pl_, counts, cam)
    cam = cam.at[0, P.C_ROW0].set(jnp.asarray(row0, jnp.float32))
    fn, (Hp, Wp) = _build_fused_mse(config, float(tau), bh, bw, interpret,
                                    band_h)
    return fn(sph, pl_, cam, _target_planes(tgt_band, Hp, Wp))


@functools.partial(jax.jit, static_argnames=("config", "tau", "bh", "bw",
                                             "interpret", "cull"))
def _soft_mse_jit(scene, camera, target, *, config, tau, bh, bw, interpret,
                  cull):
    sph, pl_, cam = _pack_for_kernel(*P.pack_scene(scene),
                                     P.pack_camera(camera))
    fn, (Hp, Wp) = _build_fused_mse(config, tau, bh, bw, interpret,
                                    cull=cull)
    return fn(sph, pl_, cam, _target_planes(target, Hp, Wp))


def render_soft_mse_loss(scene, camera, target, config: RenderConfig,
                         tau: float | None = None, bh: int | None = None,
                         bw: int | None = None, interpret: bool = False,
                         cull: bool = True):
    """Fused-loss training step primitive: mean(((rgb - target)/255)^2)
    of the soft render, differentiable in scene, camera and target;
    target is [H, W, 3]. Same value and gradients as
    jnp.mean(((render_frame_soft(...).rgb - target)/255)**2) (tests pin
    the parity). bh/bw override the power-of-two tile (tiles.pick_tile);
    interpret=True runs the kernel in the Pallas interpreter (CPU tests);
    cull=False turns the two-level culling off (the exact baseline)."""
    tau = config.soft_tau if tau is None else tau
    if tau <= 0.0:
        raise ValueError("render_soft_mse_loss needs tau > 0")
    dbh, dbw = tiles.pick_tile(config.height, config.width)
    return _soft_mse_jit(scene, camera, target, config=config,
                         tau=float(tau), bh=bh or dbh, bw=bw or dbw,
                         interpret=interpret, cull=cull)
