"""Camera movement / rotation controller (host-side, between frames).

Replaces Camera3D::Move / ::AddRot (Camera3D.cpp:142-187) and the key-state
struct (Camera3D.h:37-48). Pure NumPy functions over the Camera pytree:
they run on the host every frame between jitted render steps (where the
reference runs them on the CPU between kernel launches), so they must not
dispatch per-frame eager device ops - each of those is a device round
trip.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from rtwc_tpu.camera.camera import Camera

_PITCH_LIMIT = math.pi / 2.0 - 1e-4  # Camera3D.cpp:178-186


@dataclasses.dataclass
class Keys:
    """Pressed-key state (Camera3D.h:37-48 PressedKeys)."""

    w: int = 0
    a: int = 0
    s: int = 0
    d: int = 0
    space: int = 0
    shift: int = 0


def move(camera: Camera, keys: Keys, dt: float, speed: float = 10.0) -> Camera:
    """WASD/space/shift movement (Camera3D.cpp:142-163).

    Planar movement uses the yaw-only basis (including its junk y
    component - see camera.static_basis); the combined direction is
    normalized as a full 3-vector and only its x/z are applied. Vertical
    movement is unrotated space-shift.
    """
    ds = float(dt) * speed
    pos = np.array(camera.pos, np.float32)
    rot = np.asarray(camera.rot, np.float32)
    y = float(rot[1])
    sy, cy = math.sin(y), math.cos(y)
    static_right = np.array([cy, -sy, -sy], np.float32)
    static_forward = np.array([-sy, -cy, -cy], np.float32)
    total = static_right * float(keys.d - keys.a) + static_forward * float(keys.w - keys.s)
    norm = float(np.linalg.norm(total))
    if norm > 0.0:
        total = total / norm
    pos[0] += total[0] * ds
    pos[2] += total[2] * ds
    pos[1] += float(keys.space - keys.shift) * ds
    return camera.replace(pos=pos)


def add_rot(
    camera: Camera,
    dp: float,
    dy: float,
    dr: float = 0.0,
    sensitivity: float = 0.002,
) -> Camera:
    """Mouse-delta rotation (Camera3D.cpp:166-187): pitch -= dp*s,
    yaw += dy*s, roll += dr*s, pitch clamped just inside +-pi/2.
    Deliberately NOT scaled by dt (Camera3D.cpp:170-172)."""
    rot = np.array(camera.rot, np.float32)
    rot += np.array([-dp * sensitivity, dy * sensitivity, dr * sensitivity], np.float32)
    rot[0] = min(max(float(rot[0]), -_PITCH_LIMIT), _PITCH_LIMIT)
    return camera.replace(rot=rot)
