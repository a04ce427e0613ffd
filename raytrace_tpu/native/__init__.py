"""Native (C++) runtime components, loaded via ctypes.

The compute path is JAX/XLA; the host-side runtime around it uses
native code where Python is the bottleneck.  Currently: the .obj mesh
loader (objparse.cpp) — ~11x the pure-Python parser on mesh-scale
files (measured on the CPU: 200k tris, 10 MB).

Shared objects build lazily with g++ on first use and are cached next to
the source keyed by a source hash, so a source edit rebuilds and a stale
.so is never used.  Everything degrades gracefully: no compiler or a
failed build falls back to the Python implementations with identical
semantics (tests assert parity); ``parse_obj(native=False)`` asks for
the Python parser.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIBS: dict[str, ctypes.CDLL | None] = {}


def _build_and_load(name: str) -> ctypes.CDLL | None:
    """Compile ``<name>.cpp`` into a cached .so and dlopen it."""
    if name in _LIBS:
        return _LIBS[name]
    lib = None
    try:
        src = os.path.join(_DIR, name + ".cpp")
        with open(src, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(_DIR, f"_{name}-{tag}.so")
        if not os.path.exists(so):
            # build to a temp name + atomic rename: concurrent test
            # processes may race to build the same .so
            fd, tmp = tempfile.mkstemp(dir=_DIR, suffix=".so")
            os.close(fd)
            try:
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                     "-o", tmp, src],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(so)
    except Exception:
        lib = None
    _LIBS[name] = lib
    return lib


def obj_lib() -> ctypes.CDLL | None:
    """The .obj parser library, or None if native is unavailable."""
    lib = _build_and_load("objparse")
    if lib is not None and not getattr(lib, "_rt_configured", False):
        lib.rt_parse_obj.restype = ctypes.c_int
        lib.rt_parse_obj.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_long)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_long)),
            ctypes.POINTER(ctypes.c_long),
            ctypes.c_char_p, ctypes.c_long,
        ]
        lib.rt_obj_free.restype = None
        lib.rt_obj_free.argtypes = [ctypes.c_void_p]
        lib._rt_configured = True
    return lib
