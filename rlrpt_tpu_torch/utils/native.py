"""ctypes bindings of the native IO runtime (counterpart of
``rlrpt_tpu/utils/native.py``).

The reference's data layer is C++ (OBJ importer object_importer.cu,
Q-table text IO radiance_map.cu:237-268, BMP dump sdl_screen.cpp:60-66);
``csrc/rlrpt_io.cpp`` at the repository root is its native equivalent,
shared with the JAX package.  This module compiles it with the host's
C++ compiler at first use, never at import, into ``build/native/`` (a
directory git ignores); the library's name carries a hash of the source
and flags, so an edited source is rebuilt and an unchanged one reused.
The pure-Python parse in ``scene/obj_importer.py`` stays the plain
version; ``have_native()`` says which path is live, and ``build_error()``
why the native one is not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "csrc" / "rlrpt_io.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib: ctypes.CDLL | None = None
_error: str | None = None


def _build() -> Path:
    """The library's path, compiled first if no build of this source and
    these flags exists.  Raises RuntimeError when it cannot be built."""
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} is missing")
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    so = BUILD_DIR / f"librlrpt_io_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler: g++ (or $CXX) is not on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # each process builds under its own name, then renames: concurrent
    # test workers never load a half-written file
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL | None:
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build()))
    except (RuntimeError, OSError) as e:
        _error = str(e)
        return None
    lib.rlrpt_obj_load.restype = ctypes.c_void_p
    lib.rlrpt_obj_load.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.rlrpt_obj_copy.restype = None
    lib.rlrpt_obj_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p]
    lib.rlrpt_obj_free.restype = None
    lib.rlrpt_obj_free.argtypes = [ctypes.c_void_p]
    lib.rlrpt_save_q_table.restype = ctypes.c_int
    lib.rlrpt_save_q_table.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int64]
    lib.rlrpt_load_q_table.restype = ctypes.c_int64
    lib.rlrpt_load_q_table.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int64)]
    lib.rlrpt_write_bmp.restype = ctypes.c_int
    lib.rlrpt_write_bmp.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_int64]
    _lib = lib
    return _lib


def have_native() -> bool:
    """True when the native library is built and loaded."""
    return _load() is not None


def build_error() -> str | None:
    """Why the native library is not live (None when it is, or before the
    first attempt)."""
    return _error


def parse_obj_native(path: str, normalise: bool = True):
    """Native OBJ parse (fan triangulation, ``x/x/x`` tokens) and, by
    default, the reference normalisation in float32 arithmetic.

    Returns (verts (V, 3) float32, faces (F, 3) int64, 1-based), or None
    when the library is not available."""
    lib = _load()
    if lib is None:
        return None
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    h = lib.rlrpt_obj_load(str(path).encode(), int(normalise),
                           ctypes.byref(nv), ctypes.byref(nt))
    if not h:
        raise FileNotFoundError(path)
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nt.value, 3), np.int64)
    lib.rlrpt_obj_copy(h, verts.ctypes.data_as(ctypes.c_void_p),
                       faces.ctypes.data_as(ctypes.c_void_p))
    lib.rlrpt_obj_free(h)
    return verts, faces


def save_q_table_native(path: str, pos: np.ndarray, q: np.ndarray) -> bool:
    """Write radiance_map_data.txt text ("S" then "x y z q1..qS" rows,
    %.6g); False when the library is not available."""
    lib = _load()
    if lib is None:
        return False
    pos = np.ascontiguousarray(pos, np.float32)
    q = np.ascontiguousarray(q, np.float32)
    if pos.ndim != 2 or pos.shape[1] != 3 or q.ndim != 2 \
            or q.shape[0] != pos.shape[0]:
        raise ValueError(f"pos must be (V, 3) and q (V, S), got "
                         f"{pos.shape} and {q.shape}")
    rc = lib.rlrpt_save_q_table(str(path).encode(),
                                pos.ctypes.data_as(ctypes.c_void_p),
                                q.ctypes.data_as(ctypes.c_void_p),
                                pos.shape[0], q.shape[1])
    return rc == 0


def load_q_table_native(path: str):
    """(pos (V, 3), q (V, S)) float32 from Q-table text, or None when the
    library is not available."""
    lib = _load()
    if lib is None:
        return None
    ns = ctypes.c_int64()
    count = lib.rlrpt_load_q_table(str(path).encode(), None, None,
                                   ctypes.byref(ns))
    if count < 0:
        raise FileNotFoundError(path)
    pos = np.empty((count, 3), np.float32)
    q = np.empty((count, ns.value), np.float32)
    lib.rlrpt_load_q_table(str(path).encode(),
                           pos.ctypes.data_as(ctypes.c_void_p),
                           q.ctypes.data_as(ctypes.c_void_p),
                           ctypes.byref(ns))
    return pos, q


def write_bmp_native(path: str, img_u8: np.ndarray) -> bool:
    """A 24-bit BMP of an (H, W, 3) uint8 image; False when the library is
    not available."""
    lib = _load()
    if lib is None:
        return False
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    if img_u8.ndim != 3 or img_u8.shape[2] != 3:
        raise ValueError(f"image must be (H, W, 3), got {img_u8.shape}")
    h, w, _ = img_u8.shape
    rc = lib.rlrpt_write_bmp(str(path).encode(),
                             img_u8.ctypes.data_as(ctypes.c_void_p), w, h)
    return rc == 0
