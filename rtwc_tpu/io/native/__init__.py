"""ctypes loader for the native C++ ANSI encoder (ansi_encoder.cpp).

The runtime around the device compute path stays native where the reference's
is (PrintMachine/Minimize* are C++ host code, RayTracingManager.cu:167-319,
PrintMachine.cpp): the per-frame byte-formatting pass is the host hot loop
at large resolutions, so it is compiled C++, built on demand with g++ into
a cached shared object. Python falls back to encode.py's NumPy encoder when
no compiler is available (encode.encode_frame handles that).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "ansi_encoder.cpp")
_PRINT_SRC = os.path.join(os.path.dirname(__file__), "print_machine.cpp")
_LIB_NAME = "librtwc_ansi.so"
_PRINT_LIB_NAME = "librtwc_print.so"
_lib = None
_print_lib = None


def _build_dir() -> str:
    d = os.path.join(os.path.dirname(__file__), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def _compile(src: str, lib_name: str, extra_flags=()) -> str:
    """Build src -> _build/lib_name if stale; returns the .so path.

    Atomic build: compile to a temp name, rename into place, so concurrent
    processes never dlopen a half-written object."""
    so = os.path.join(_build_dir(), lib_name)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build_dir())
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             *extra_flags, "-o", tmp, src],
            check=True, capture_output=True,
        )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    _lib = ctypes.CDLL(_compile(_SRC, _LIB_NAME))
    _lib.rtwc_encode_frame.restype = ctypes.c_int64
    _lib.rtwc_encode_frame.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    return _lib


def encode_frame_native(kind: np.ndarray, color: np.ndarray, char: np.ndarray) -> bytes:
    """C++ encode; same byte contract as encode.encode_frame_numpy."""
    lib = _load()
    H, W = kind.shape
    truecolor = 1 if color.ndim == 3 else 0
    kind32 = np.ascontiguousarray(kind, np.int32)
    color32 = np.ascontiguousarray(color, np.int32)
    char32 = np.ascontiguousarray(char, np.int32)
    out = np.empty(H * W * 20 + H, np.uint8)
    n = lib.rtwc_encode_frame(
        kind32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        color32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        char32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        H, W, truecolor,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out[:n].tobytes()


def _load_print() -> ctypes.CDLL:
    global _print_lib
    if _print_lib is not None:
        return _print_lib
    lib = ctypes.CDLL(_compile(_PRINT_SRC, _PRINT_LIB_NAME,
                               extra_flags=("-pthread",)))
    lib.rtwc_printer_start.restype = ctypes.c_void_p
    lib.rtwc_printer_start.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_double]
    lib.rtwc_printer_publish.restype = None
    lib.rtwc_printer_publish.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.rtwc_printer_set_rendering_fps.restype = None
    lib.rtwc_printer_set_rendering_fps.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.rtwc_printer_printing_fps.restype = ctypes.c_double
    lib.rtwc_printer_printing_fps.argtypes = [ctypes.c_void_p]
    lib.rtwc_printer_running.restype = ctypes.c_int
    lib.rtwc_printer_running.argtypes = [ctypes.c_void_p]
    lib.rtwc_printer_stop.restype = None
    lib.rtwc_printer_stop.argtypes = [ctypes.c_void_p]
    _print_lib = lib
    return lib


class NativePrintMachine:
    """ctypes handle on the C++ print thread (print_machine.cpp) - the
    native runtime analogue of PrintMachine's detached print thread
    (PrintMachine.cpp:150-151,257-306). The blit runs entirely outside the
    GIL; Python only publishes encoded frames."""

    def __init__(self, fd: int, show_fps: bool, min_period: float = 0.0):
        self._lib = _load_print()
        self._h = self._lib.rtwc_printer_start(fd, 1 if show_fps else 0,
                                               float(min_period))
        if not self._h:
            raise RuntimeError("rtwc_printer_start failed")

    def publish(self, frame: bytes) -> None:
        buf = (ctypes.c_uint8 * len(frame)).from_buffer_copy(frame)
        self._lib.rtwc_printer_publish(self._h, buf, len(frame))

    def set_rendering_fps(self, fps: float) -> None:
        self._lib.rtwc_printer_set_rendering_fps(self._h, float(fps))

    @property
    def printing_fps(self) -> float:
        return float(self._lib.rtwc_printer_printing_fps(self._h))

    def running(self) -> bool:
        return bool(self._lib.rtwc_printer_running(self._h))

    def stop(self) -> None:
        if self._h:
            self._lib.rtwc_printer_stop(self._h)
            self._h = None
