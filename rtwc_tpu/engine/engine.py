"""Engine: the interactive frame loop.

Replaces Engine3D (Engine3D.h/.cpp): owns timer, camera, scene, presenter,
and the jitted render step; per frame it polls input, integrates camera
movement, renders, and hands encoded bytes to the presenter; once per
second it publishes FPS and spawns a random test sphere (Engine3D.cpp:30-79).

Structure of one frame (vs RayTracingManager::Update's
upload -> kernels -> sync -> D2H -> minimize -> publish sequence,
RayTracingManager.cu:76-154):

  1. one jitted, donated-input step fuses scene physics + ray trace +
     shading + mode head on device; only the compact cell arrays leave HBM;
  2. JAX async dispatch overlaps frame k+1's device work with the host-side
     ANSI encode + publish of frame k (the reference needed an explicit
     cudaDeviceSynchronize; here the data dependency is the sync);
  3. the presenter thread blits at its own rate (same decoupled two-rate
     design as PrintMachine).
"""
from __future__ import annotations

import functools
import logging

import jax
import numpy as np

from rtwc_tpu.camera import Camera, default_camera, move, add_rot
from rtwc_tpu.config import EngineConfig, RenderConfig, RenderMode
from rtwc_tpu.heads import framebuffer_to_cells, encode_frame
from rtwc_tpu.io import ConsolePresenter, FramebufferSink, InputHandler
from rtwc_tpu.render import render_frame
from rtwc_tpu.render.backend import use_kernels
from rtwc_tpu.scene import (
    Scene, default_scene, grow_scene, spawn_random_sphere, update_scene,
)
from rtwc_tpu.utils import Timer, Telemetry

log = logging.getLogger("rtwc_tpu")


def _pick_renderer():
    """Display-path forward renderer: the fused kernel on the GPU
    (render/pallas_kernel.py), the jnp reference renderer on the CPU
    (they are allclose; tests/test_pallas.py). render/backend.py decides."""
    if use_kernels():
        from rtwc_tpu.render.pallas_kernel import render_frame_pallas

        return render_frame_pallas
    return render_frame


@functools.partial(jax.jit, static_argnums=(3,), donate_argnums=(0,))
def _render_step(scene: Scene, camera: Camera, dt, config: RenderConfig):
    """One fused device step: physics + render (+ AA downsample) + mode head."""
    from rtwc_tpu.render.reference import downsample_framebuffer, supersampled_config

    scene = update_scene(scene, dt, config.bob_min_y, config.bob_max_y)
    fb = _pick_renderer()(scene, camera, supersampled_config(config))
    fb = downsample_framebuffer(fb, config.supersample)
    cells = framebuffer_to_cells(fb, config)
    return scene, cells


class Engine:
    def __init__(
        self,
        render_config: RenderConfig | None = None,
        engine_config: EngineConfig | None = None,
        scene: Scene | None = None,
        camera: Camera | None = None,
        presenter=None,
        input_handler=None,
        interactive: bool = True,
    ):
        self.rcfg = render_config or RenderConfig()
        self.ecfg = engine_config or EngineConfig()
        self.scene = scene if scene is not None else default_scene(self.rcfg, seed=self.ecfg.seed)
        self.camera = camera if camera is not None else default_camera()
        self.presenter = presenter or ConsolePresenter(
            self.rcfg.width, self.rcfg.height, show_fps=self.ecfg.show_fps,
            max_print_fps=self.ecfg.max_print_fps,
        )
        self.input = input_handler if input_handler is not None else (
            InputHandler(mouse=self.ecfg.mouse) if interactive else None
        )
        self.timer = Timer()
        self.telemetry = Telemetry(
            # supersample=N traces N^2 rays per cell before the AA downsample
            rays_per_frame=self.rcfg.width * self.rcfg.height
            * self.rcfg.supersample ** 2,
            update_interval_s=self.ecfg.fps_update_interval_s,
        )
        self._rng = np.random.default_rng(self.ecfg.seed)
        self._should_quit = False
        self._pending = None  # (cells, ) of the in-flight frame

    # -- lifecycle (Engine3D::Start / CleanUp) --------------------------------

    def start(self) -> None:
        self.presenter.start()
        if self.input is not None:
            self.input.start()
        self.timer.update()

    def cleanup(self) -> None:
        if self.input is not None:
            self.input.cleanup()
        self.presenter.cleanup()

    # -- per-frame (Engine3D::Run) --------------------------------------------

    def run_frame(self) -> bool:
        """One iteration of while(engine->Run()) (Entrypoint.cpp:9).
        Returns False when the loop should exit."""
        if not self.presenter.check_if_running():
            return False
        if self._should_quit:
            return False

        self.timer.update()
        dt = self.timer.delta_time

        if self.input is not None:
            state = self.input.poll()
            if state.quit:
                self._should_quit = True
            if state.mode is not None and state.mode != self.rcfg.mode:
                self.rcfg = self.rcfg.replace(mode=state.mode)  # recompiles once per mode
            dp, dy = state.rot_delta
            if dp or dy:
                self.camera = add_rot(self.camera, dp, dy, 0.0, self.rcfg.mouse_sensitivity)
            self.camera = move(self.camera, state.keys, dt, self.rcfg.move_speed)

        # Launch this frame's device work (async), then encode/publish the
        # previous frame while the device runs.
        self.scene, cells = _render_step(
            self.scene, self.camera, np.float32(dt), self.rcfg
        )
        prev, self._pending = self._pending, cells
        if prev is not None:
            self._publish(prev)

        if self.telemetry.tick():
            if self.ecfg.spawn:
                self._spawn()
            self.presenter.update_rendering_fps(self.telemetry.fps)
        return True

    def _spawn(self) -> None:
        """1 Hz random sphere (Engine3D.cpp:63). When the pool is full the
        capacity doubles first (the reference's ptr-array doubling,
        Scene3D.cpp:107-129) up to ecfg.max_grow_spheres; the next jitted
        step recompiles once per doubling - the static-shape realloc."""
        cap = self.scene.spheres.capacity
        if self.scene.n_spheres >= cap:
            if not self.ecfg.auto_grow or cap >= self.ecfg.max_grow_spheres:
                return  # same silent refusal as the reference at its cap
            self.scene = grow_scene(
                self.scene,
                max_spheres=min(cap * 2, self.ecfg.max_grow_spheres),
            )
            log.info("scene grown to %d sphere slots", self.scene.spheres.capacity)
        self.scene = spawn_random_sphere(self.scene, self._rng)

    def _publish(self, cells) -> None:
        kind, color, char = jax.device_get(cells)
        frame = encode_frame(kind, color, char)
        self.presenter.set_data_in_back_buffer(frame)

    def flush(self) -> None:
        """Drain the in-flight frame (used on shutdown and by tests)."""
        if self._pending is not None:
            self._publish(self._pending)
            self._pending = None

    def run(self, max_frames: int | None = None) -> None:
        """The main loop (Entrypoint.cpp:4-13)."""
        self.start()
        try:
            n = 0
            while self.run_frame():
                n += 1
                if max_frames is not None and n >= max_frames:
                    break
            self.flush()
        finally:
            self.cleanup()
