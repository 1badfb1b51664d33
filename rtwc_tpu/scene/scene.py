"""Scene as a struct-of-arrays pytree.

The reference keeps a GPU-resident object database: a device array of
polymorphic Object3D* pointers plus fixed 5 MB data pools per concrete type,
grown by cudaMemcpy / pointer juggling (Scene3D.cpp:7-34,36-86,107-164).
Virtual dispatch is replaced by a type switch because CUDA can't copy
vtables across the PCIe bus (Object3D.h:43,57-59).

None of that survives contact with XLA's static-shape world, and it
shouldn't: the idiomatic design is per-type struct-of-arrays padded to a
static capacity with an active mask. "Type dispatch" becomes two batched
intersection calls + a minimum-combine; "dynamic growth" (the reference
spawns a sphere every second, Engine3D.cpp:63) becomes a functional
at[slot].set outside jit, never changing array shapes - so the jitted
render step never recompiles.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from rtwc_tpu.config import RenderConfig
from rtwc_tpu.mathx import pytree_dataclass


@pytree_dataclass
class Spheres:
    """Padded sphere pool (Sphere.h:6-24 fields, minus the vtable).

    color is stored 0..255 float like the reference (Object3D.h color).
    speed/mover drive the bobbing animation (Sphere.cu:6-23): each sphere
    oscillates on y inside [bob_min_y, bob_max_y] at `speed` units/s,
    `mover` is the current direction (+1/-1). active marks live slots.
    """

    center: jax.Array  # [N, 3] f32
    radius: jax.Array  # [N]    f32
    color: jax.Array   # [N, 3] f32, 0..255
    speed: jax.Array   # [N]    f32
    mover: jax.Array   # [N]    f32 (+1 / -1)
    active: jax.Array  # [N]    f32 (1.0 live, 0.0 dead)

    @property
    def capacity(self) -> int:
        return self.center.shape[0]


@pytree_dataclass
class Planes:
    """Padded finite-axis-aligned-rectangle pool (Plane.h:6-37).

    A plane is a rectangle centered at `center` with normal `normal`,
    world-space x-extent `width` and z-extent `height` (Plane.cu:59-68).
    """

    center: jax.Array  # [M, 3]
    normal: jax.Array  # [M, 3] (unit)
    color: jax.Array   # [M, 3] 0..255
    width: jax.Array   # [M]
    height: jax.Array  # [M]
    active: jax.Array  # [M]


@pytree_dataclass
class Scene:
    spheres: Spheres
    planes: Planes

    @property
    def n_spheres(self) -> int:
        """Host-side live count (only valid outside jit)."""
        return int(np.asarray(self.spheres.active).sum())

    @property
    def n_planes(self) -> int:
        return int(np.asarray(self.planes.active).sum())


def empty_scene(max_spheres: int = 256, max_planes: int = 16) -> Scene:
    """All-inactive padded scene of static capacity.

    Scene construction/mutation happens on the HOST in NumPy: leaves are
    np arrays until the first jitted step consumes them. Eager per-element
    device ops here would cost a device round-trip each; the jitted
    render step uploads the whole scene in
    one transfer - the moral equivalent of the reference's single
    cudaMemcpy per created object (Scene3D.cpp:53-56), minus the chatter.
    """
    f = np.float32
    return Scene(
        spheres=Spheres(
            center=np.zeros((max_spheres, 3), f),
            radius=np.ones((max_spheres,), f),
            color=np.zeros((max_spheres, 3), f),
            speed=np.ones((max_spheres,), f),
            mover=-np.ones((max_spheres,), f),
            active=np.zeros((max_spheres,), f),
        ),
        planes=Planes(
            center=np.zeros((max_planes, 3), f),
            normal=np.tile(np.array([[0.0, 1.0, 0.0]], f), (max_planes, 1)),
            color=np.zeros((max_planes, 3), f),
            width=np.ones((max_planes,), f),
            height=np.ones((max_planes,), f),
            active=np.zeros((max_planes,), f),
        ),
    )


def add_sphere(
    scene: Scene,
    radius: float,
    center,
    color,
    speed: float | None = None,
    rng: np.random.Generator | None = None,
) -> Scene:
    """Functional append into the first free slot (host-side, outside jit).

    Mirrors Scene3D::CreateSphere (Scene3D.cpp:36-60): refuses silently when
    the pool is full (the reference returns without creating,
    Scene3D.cpp:42-45). The random bob speed in [1.0, 4.0) follows
    Sphere.cu:11-12 (rand()%300+100 / 100).
    """
    sp = scene.spheres
    slot = int(np.asarray(sp.active).sum())
    if slot >= sp.capacity:
        return scene  # pool full: same silent refusal as the reference
    if speed is None:
        rng = rng or np.random.default_rng()
        speed = float(rng.integers(100, 400)) / 100.0

    def upd(arr, value):
        out = np.array(arr, np.float32)  # host copy (device pull if needed)
        out[slot] = value
        return out

    sp = sp.replace(
        center=upd(sp.center, np.asarray(center, np.float32)),
        radius=upd(sp.radius, float(radius)),
        color=upd(sp.color, np.asarray(color, np.float32)),
        speed=upd(sp.speed, float(speed)),
        mover=upd(sp.mover, -1.0),
        active=upd(sp.active, 1.0),
    )
    return scene.replace(spheres=sp)


def add_plane(scene: Scene, center, normal, color, width: float, height: float) -> Scene:
    """Functional append of a finite plane (Scene3D.cpp:62-86). The normal
    is normalized on creation like Plane's ctor (Plane.cu:9)."""
    pl = scene.planes
    slot = int(np.asarray(pl.active).sum())
    if slot >= pl.active.shape[0]:
        return scene
    n = np.asarray(normal, np.float64)
    n = (n / max(np.linalg.norm(n), 1e-20)).astype(np.float32)

    def upd(arr, value):
        out = np.array(arr, np.float32)
        out[slot] = value
        return out

    pl = pl.replace(
        center=upd(pl.center, np.asarray(center, np.float32)),
        normal=upd(pl.normal, n),
        color=upd(pl.color, np.asarray(color, np.float32)),
        width=upd(pl.width, float(width)),
        height=upd(pl.height, float(height)),
        active=upd(pl.active, 1.0),
    )
    return scene.replace(planes=pl)


def default_scene(config: RenderConfig | None = None, seed: int = 0) -> Scene:
    """The reference's seed scene: 5 spheres + 1 ground plane
    (Scene3D.cpp:28-33, exact radii/positions/colors)."""
    config = config or RenderConfig()
    rng = np.random.default_rng(seed)
    s = empty_scene(config.max_spheres, config.max_planes)
    s = add_sphere(s, 7.0, (0.0, 10.0, 20.0), (255.0, 1.0, 1.0), rng=rng)
    s = add_sphere(s, 6.0, (5.0, 10.0, 20.0), (1.0, 255.0, 1.0), rng=rng)
    s = add_sphere(s, 10.0, (10.0, 10.0, 40.0), (1.0, 1.0, 255.0), rng=rng)
    s = add_sphere(s, 3.0, (5.0, 10.0, 20.0), (225.0, 210.0, 20.0), rng=rng)
    s = add_sphere(s, 4.0, (-5.0, 10.0, 40.0), (225.0, 10.0, 220.0), rng=rng)
    s = add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0), 10.0, 20.0)
    return s


def grow_scene(scene: Scene, max_spheres: int | None = None,
               max_planes: int | None = None) -> Scene:
    """Return the same scene padded to a larger static capacity.

    The reference grows its device pointer array by doubling (cudaMalloc +
    cudaMemcpy + cudaFree, Scene3D.cpp:107-129, capped at 100 MB). Under
    XLA, growth is a host-side pad with inactive slots: array shapes
    change, so the next jitted step recompiles once per doubling - the
    compile is the realloc. Shrinking is refused (live slots would
    be lost); passing the current capacity is a no-op.
    """
    sp, pl = scene.spheres, scene.planes
    ns = sp.capacity if max_spheres is None else max_spheres
    npl = pl.active.shape[0] if max_planes is None else max_planes
    if ns < sp.capacity or npl < pl.active.shape[0]:
        raise ValueError(
            f"grow_scene cannot shrink: have {sp.capacity}x{pl.active.shape[0]}, "
            f"asked {ns}x{npl}")

    def pad(arr, n, template_row=0.0):
        arr = np.asarray(arr, np.float32)
        extra = n - arr.shape[0]
        if extra == 0:
            return arr
        fill = np.full((extra,) + arr.shape[1:], template_row, np.float32)
        return np.concatenate([arr, fill], axis=0)

    new_sp = Spheres(
        center=pad(sp.center, ns), radius=pad(sp.radius, ns, 1.0),
        color=pad(sp.color, ns), speed=pad(sp.speed, ns, 1.0),
        mover=pad(sp.mover, ns, -1.0), active=pad(sp.active, ns),
    )
    normal = np.asarray(pl.normal, np.float32)
    extra = npl - normal.shape[0]
    if extra:
        normal = np.concatenate(
            [normal, np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (extra, 1))])
    new_pl = Planes(
        center=pad(pl.center, npl), normal=normal, color=pad(pl.color, npl),
        width=pad(pl.width, npl, 1.0), height=pad(pl.height, npl, 1.0),
        active=pad(pl.active, npl),
    )
    return Scene(spheres=new_sp, planes=new_pl)


def spawn_random_sphere(scene: Scene, rng: np.random.Generator) -> Scene:
    """The 1 Hz test spawn (Engine3D.cpp:63): radius rand()%10, position
    components rand()%100-50, color components rand()%255."""
    return add_sphere(
        scene,
        radius=float(rng.integers(0, 10)),
        center=rng.integers(-50, 50, size=3).astype(np.float32),
        color=rng.integers(0, 255, size=3).astype(np.float32),
        rng=rng,
    )


def random_scene(
    n_spheres: int,
    n_planes: int = 1,
    max_spheres: int | None = None,
    max_planes: int | None = None,
    seed: int = 0,
    spread: float = 40.0,
) -> Scene:
    """Benchmark scene generator (BASELINE configs 3-5: 20/100/200 spheres)."""
    rng = np.random.default_rng(seed)
    s = empty_scene(max_spheres or max(n_spheres, 32), max_planes or max(n_planes, 4))
    for _ in range(n_spheres):
        s = add_sphere(
            s,
            radius=float(rng.uniform(1.0, 6.0)),
            center=np.array([rng.uniform(-spread, spread), rng.uniform(-5, 25), rng.uniform(10, 10 + 2 * spread)]),
            color=rng.uniform(1, 255, size=3),
            rng=rng,
        )
    for _ in range(n_planes):
        s = add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0), 2 * spread, 2 * spread)
    return s


def update_scene(scene: Scene, dt: jax.Array, bob_min_y: float = -10.0, bob_max_y: float = 10.0) -> Scene:
    """Pure-functional physics tick, vectorized over all spheres.

    Replaces the per-object CUDA kernel (RayTracingManager.cu:10-44 launching
    Sphere::Update, Sphere.cu:15-23): y += speed * mover * dt; on leaving
    [bob_min_y, bob_max_y] clamp y and flip direction. Planes are static
    (Plane.cu:14-18). Jittable; runs fused into the render step.
    """
    sp = scene.spheres
    y = sp.center[:, 1] + sp.speed * sp.mover * dt
    out = (y < bob_min_y) | (y > bob_max_y)
    y = jnp.clip(y, bob_min_y, bob_max_y)
    mover = jnp.where(out, -sp.mover, sp.mover)
    # Inactive slots keep their state bit-for-bit (masked write).
    live = sp.active > 0.5
    center = jnp.asarray(sp.center).at[:, 1].set(jnp.where(live, y, sp.center[:, 1]))
    mover = jnp.where(live, mover, sp.mover)
    return scene.replace(spheres=sp.replace(center=center, mover=mover))
