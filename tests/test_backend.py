"""CPU tests of what surrounds the GPU kernels: the one backend choice,
tile shapes, table padding, the cross-tile compensated reduction, the
precision of the broad-phase products, the compile-cache placement, and
that both kernels lower for the CUDA Triton route (the lowering runs here;
only the GPU compiles the result)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtwc_tpu.camera import default_camera
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.render import pack as P
from rtwc_tpu.render import tiles
from rtwc_tpu.render.backend import use_kernels
from rtwc_tpu.scene import add_sphere, empty_scene, random_scene


@pytest.mark.parametrize("platform,kernels", [("gpu", True), ("cpu", False)])
def test_backend_choice(platform, kernels):
    assert use_kernels(platform) is kernels


def test_backend_rejects_other_platforms():
    with pytest.raises(RuntimeError, match="no renderer"):
        use_kernels("tpu")


def _is_pow2(n):
    return n > 0 and n & (n - 1) == 0


@pytest.mark.parametrize("height,width", [(150, 400), (500, 1920),
                                          (1080, 1920), (2160, 3840)])
def test_pick_tile_powers_of_two(height, width):
    bh, bw = tiles.pick_tile(height, width)
    assert (bh, bw) == tiles.TILE
    assert _is_pow2(bh) and _is_pow2(bw), (bh, bw)
    params = tiles.compiler_params(bh, bw)
    assert _is_pow2(params.num_warps) and params.num_stages == 1
    # the padded grid covers the image with less than one tile of waste
    assert 0 <= tiles.round_up(height, bh) - height < bh
    # images smaller than a tile shrink the tile to the next power of two
    assert tiles.pick_tile(5, 12) == (8, 16)


@pytest.mark.parametrize("n", [1, 5, 20, 200])
def test_pad_objects_power_of_two(n):
    scene = random_scene(min(n, 8), max_spheres=n, max_planes=3, seed=0)
    sph, pl_, _ = P.pack_scene(scene)
    psph, ppl = tiles.pad_objects(sph), tiles.pad_objects(pl_)
    assert psph.shape == (P.SPH_ROWS, tiles.next_pow2(n))
    assert ppl.shape == (P.PL_ROWS, 4)
    np.testing.assert_array_equal(np.asarray(psph[:, :n]), np.asarray(sph))
    assert (np.asarray(psph[:, n:]) == 0).all()      # inactive, never listed
    # gradients flow back through the padding to the real columns only
    g = jax.grad(lambda t: jnp.sum(tiles.pad_objects(t) ** 2))(sph)
    np.testing.assert_allclose(np.asarray(g), 2.0 * np.asarray(sph))


def test_twofloat_reduce_matches_exact_sum():
    """The cross-tile reduction of the kernel's per-tile (hi, lo) camera
    partials: against a float64 sum of adversarially cancelling partials
    it is exact to double-float precision, where a plain float32 sum
    loses the total."""
    from rtwc_tpu.render.pallas_soft import twofloat_reduce

    rng = np.random.RandomState(0)
    t, k = 510, 16
    big = rng.randn(t, k) * 1e5
    hi = np.concatenate([big, -big], 0).astype(np.float32)  # cancels
    lo = (rng.randn(2 * t, k) * 1e-3).astype(np.float32)
    truth = hi.astype(np.float64).sum(0) + lo.astype(np.float64).sum(0)
    mass = np.abs(hi.astype(np.float64)).sum(0)       # what cancels away
    s, e = twofloat_reduce(jnp.asarray(hi), jnp.asarray(lo))
    got = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    assert (np.abs(got - truth) <= 1e-12 * mass).all(), np.abs(got - truth) / mass
    plain = np.asarray(jnp.sum(jnp.asarray(hi) + jnp.asarray(lo), axis=0))
    assert np.abs(plain - truth).max() > 1e3 * np.abs(got - truth).max()


def test_tile_lists_highest_precision_grazing():
    """Every product of the broad phase asks for HIGHEST precision (so the
    GPU cannot run it in TF32), and a sphere whose silhouette only grazes
    the frame is still listed by the tiles it touches."""
    cfg = RenderConfig(width=64, height=32, max_spheres=4, max_planes=2,
                       shadows=True)
    cam = P.pack_camera(default_camera())
    bh, bw = tiles.pick_tile(cfg.height, cfg.width)
    grid = (cfg.height // bh, cfg.width // bw)

    def build(sph, pl_, cam):
        return tiles.build_tile_lists(sph, pl_, cam, cfg, 0.5, bh, bw, grid,
                                      shadows=True)

    s = empty_scene(4, 2)
    s = add_sphere(s, 4.0, (0.0, 0.0, 30.0), (200.0, 40.0, 40.0), speed=1.0)
    sph, pl_, _ = P.pack_scene(s)
    hlo = jax.jit(build).lower(sph, pl_, cam).as_text()
    dots = [l for l in hlo.splitlines() if "dot_general" in l]
    assert dots and all("HIGHEST" in l for l in dots), dots

    # Grazing: a unit sphere at distance 50 whose center direction lies
    # just outside tile 0's bounding cone, by less than its angular
    # radius arcsin(1/50) = 0.0200 rad, must be listed; one clearly
    # outside must not.
    axis, cos_cone, _ = tiles.tile_cones(cam, cfg, bh, bw, grid)
    a = np.asarray(axis[0, 0], np.float64)
    perp = np.cross(a, [0.0, 1.0, 0.0])
    perp /= np.linalg.norm(perp)
    ang = float(np.arccos(np.asarray(cos_cone[0, 0])))

    def tile0_lists(delta):
        u = np.cos(ang + delta) * a + np.sin(ang + delta) * perp
        s2 = add_sphere(empty_scene(4, 2), 1.0, tuple(50.0 * u),
                        (9.0, 9.0, 9.0), speed=1.0)
        sph2, _, _ = P.pack_scene(s2)
        lists, _ = tiles.sphere_tile_lists(sph2, cam, cfg, 0.0, bh, bw, grid,
                                           hard=True)
        return int(np.asarray(lists)[0, 0])

    assert tile0_lists(0.019) == 1
    assert tile0_lists(0.2) == 0


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    from rtwc_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_default_dir_in_checkout(monkeypatch):
    from rtwc_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        with open(os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _lower_hard():
    from rtwc_tpu.render.pallas_kernel import _render_pallas_jit

    cfg = RenderConfig(width=64, height=32, max_spheres=8, max_planes=2,
                       shadows=True)
    return _render_pallas_jit.trace(
        random_scene(4, max_spheres=8, max_planes=2, seed=0), default_camera(),
        config=cfg, bh=16, bw=32, interpret=False)


def _lower_soft():
    from rtwc_tpu.render.pallas_soft import _soft_mse_jit

    cfg = RenderConfig(width=64, height=32, max_spheres=6, max_planes=2,
                       shadows=True)
    scene = random_scene(4, max_spheres=6, max_planes=2, seed=0)
    target = jnp.zeros((32, 64, 3), jnp.float32)

    def loss(sc):
        return _soft_mse_jit(sc, default_camera(), target, config=cfg,
                             tau=0.5, bh=16, bw=32, interpret=False,
                             cull=True)

    return jax.jit(jax.value_and_grad(loss)).trace(scene)


@pytest.mark.parametrize("which", ["hard", "soft"])
def test_kernels_lower_for_cuda_triton(which):
    """Both kernels lower for the GPU with every in-kernel primitive on
    the Triton route (power-of-two shapes, no scratch memory): the
    lowered module holds exactly one Triton custom call."""
    traced = _lower_hard() if which == "hard" else _lower_soft()
    hlo = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert hlo.count("__gpu$xla.gpu.triton") == 1
