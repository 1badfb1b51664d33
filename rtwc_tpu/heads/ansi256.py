"""ANSI-256 (xterm) color quantizer, vectorized in jnp.

Behavioral re-derivation of ANSIRGB.h:114-189 (which itself derives from the
mina86 ansi_colours routine): a 24-bit RGB triple maps to the xterm-256
index by comparing the best greyscale candidate (via an integer Rec.709-ish
luminance and a 256-entry grey LUT) against the 6x6x6 cube candidate (via
per-channel threshold search), using a red-weighted perceptual distance.

Nothing is copied: the palette and the grey LUT are generated from their
definitions (the xterm cube levels [0,95,135,175,215,255], the grey ramp
(i-232)*10+8, and nearest-grey-level with ties to the lower level), and a
test pins known values against the reference's table.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# --- palette generation (ANSIRGB.h:39-112 semantics) ------------------------

_SYSTEM16 = [
    0x000000, 0xCD0000, 0x00CD00, 0xCDCD00, 0x0000EE, 0xCD00CD, 0x00CDCD, 0xE5E5E5,
    0x7F7F7F, 0xFF0000, 0x00FF00, 0xFFFF00, 0x5C5CFF, 0xFF00FF, 0x00FFFF, 0xFFFFFF,
]
_CUBE_LEVELS = np.array([0, 95, 135, 175, 215, 255], np.int64)


def _build_palette() -> np.ndarray:
    """256 x 3 uint8 palette: 16 system colours, 6x6x6 cube, 24 greys."""
    pal = np.zeros((256, 3), np.uint8)
    for i, c in enumerate(_SYSTEM16):
        pal[i] = [(c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF]
    idx = 16
    for r in _CUBE_LEVELS:
        for g in _CUBE_LEVELS:
            for b in _CUBE_LEVELS:
                pal[idx] = [r, g, b]
                idx += 1
    for i in range(24):
        v = i * 10 + 8
        pal[232 + i] = [v, v, v]
    return pal


ANSI_PALETTE = _build_palette()  # np.uint8 [256, 3]
_PALETTE_J = jnp.asarray(ANSI_PALETTE.astype(np.int32))


def _build_grey_lut() -> np.ndarray:
    """ansi256_from_grey LUT (ANSIRGB.h:143-176): for a grey value v the
    candidates are the cube diagonal (indices 16+43i, levels [0,95,...,255])
    and the grey ramp (232+i, levels 8+10i); for grey-vs-grey the weighted
    distance reduces to 4606*d^2, so the nearest level wins. Exact-midpoint
    ties resolve to the lower level for dark greys and the higher level for
    bright greys (the reference's table was generated with a perceptual
    metric whose compression flips the tie direction around v ~ 118); the
    full 256-entry table is pinned against the reference in tests."""
    cand_idx = np.array([16 + 43 * i for i in range(6)] + [232 + i for i in range(24)])
    cand_lvl = np.array(list(_CUBE_LEVELS) + [8 + 10 * i for i in range(24)])
    order = np.argsort(cand_lvl, kind="stable")
    cand_idx, cand_lvl = cand_idx[order], cand_lvl[order]
    lut = np.zeros(256, np.uint8)
    for v in range(256):
        d = np.abs(v - cand_lvl)
        minima = np.flatnonzero(d == d.min())
        best = minima[0] if v <= 118 else minima[-1]
        lut[v] = cand_idx[best]
    return lut


GREY_LUT = _build_grey_lut()
_GREY_LUT_J = jnp.asarray(GREY_LUT.astype(np.int32))

# Cube threshold tables (ANSIRGB.h:18-34): value below threshold[i] -> level i.
_THRESH_R = np.array([38, 115, 155, 196, 235], np.int32)
_THRESH_G = np.array([36, 116, 154, 195, 235], np.int32)
_THRESH_B = np.array([35, 115, 155, 195, 235], np.int32)


def _cube_channel_index(v: jax.Array, thresholds: np.ndarray) -> jax.Array:
    """CUBE_THRESHOLDS search: count of thresholds <= v gives the level idx."""
    t = jnp.asarray(thresholds)
    return jnp.sum(v[..., None] >= t, axis=-1).astype(jnp.int32)


def _distance(x: jax.Array, y: jax.Array) -> jax.Array:
    """Red-mean weighted squared distance (ANSIRGB.h:118-124). x, y int32
    [..., 3]; max value ~3e8 fits int32."""
    r_sum = x[..., 0] + y[..., 0]
    d = x - y
    return (
        (1024 + r_sum) * d[..., 0] * d[..., 0]
        + 2048 * d[..., 1] * d[..., 1]
        + (1534 - r_sum) * d[..., 2] * d[..., 2]
    )


def _luminance(rgb: jax.Array) -> jax.Array:
    """Integer luminance (ANSIRGB.h:126-133): uint32 fixed-point weights,
    rounded >>24. The accumulator peaks at ~4.28e9 which still fits uint32."""
    r = rgb[..., 0].astype(jnp.uint32)
    g = rgb[..., 1].astype(jnp.uint32)
    b = rgb[..., 2].astype(jnp.uint32)
    v = jnp.uint32(3567664) * r + jnp.uint32(11998547) * g + jnp.uint32(1211005) * b
    return ((v + jnp.uint32(1 << 23)) >> jnp.uint32(24)).astype(jnp.int32)


def ansi256_from_rgb(rgb: jax.Array) -> jax.Array:
    """Vectorized ansi256_from_rgb (ANSIRGB.h:141-189).

    rgb: [..., 3] integer (0..255, any int dtype) or float (truncated like
    the reference's uint8_t casts). Returns int32 [...] xterm indices.
    """
    rgb = jnp.asarray(rgb)
    if jnp.issubdtype(rgb.dtype, jnp.floating):
        rgb = rgb.astype(jnp.int32)  # C-style truncation toward zero
    rgb = rgb.astype(jnp.int32)

    grey_exact = _GREY_LUT_J[rgb[..., 0]]
    is_grey = (rgb[..., 0] == rgb[..., 1]) & (rgb[..., 1] == rgb[..., 2])

    grey_index = _GREY_LUT_J[_luminance(rgb)]
    grey_dist = _distance(rgb, _PALETTE_J[grey_index])

    ir = _cube_channel_index(rgb[..., 0], _THRESH_R)
    ig = _cube_channel_index(rgb[..., 1], _THRESH_G)
    ib = _cube_channel_index(rgb[..., 2], _THRESH_B)
    cube_index = 16 + 36 * ir + 6 * ig + ib
    cube_rgb = jnp.stack(
        [jnp.asarray(_CUBE_LEVELS.astype(np.int32))[i] for i in (ir, ig, ib)], axis=-1
    )
    cube_dist = _distance(rgb, cube_rgb)

    best = jnp.where(cube_dist < grey_dist, cube_index, grey_index)
    return jnp.where(is_grey, grey_exact, best).astype(jnp.int32)


def rgb_from_ansi256(index: jax.Array) -> jax.Array:
    """Palette lookup (ANSIRGB.h:114-116). Returns int32 [..., 3]."""
    return _PALETTE_J[jnp.asarray(index)]


def quantize_rgb_ste(rgb: jax.Array) -> jax.Array:
    """Straight-through-estimator quantization head: forward = the palette
    color of the chosen ANSI index, backward = identity. Keeps pipelines
    that train through the quantized console image differentiable
    (SURVEY.md section 2 row 9's native equivalent)."""
    q = rgb_from_ansi256(ansi256_from_rgb(rgb)).astype(rgb.dtype)
    return rgb + jax.lax.stop_gradient(q - rgb)
