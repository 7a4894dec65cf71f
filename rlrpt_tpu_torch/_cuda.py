"""Build and bind the package's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface, loaded with
``ctypes``.  The build happens at the first CUDA launch, never at import,
into ``build/kernels/`` beside the package (a directory git ignores); the
library's file name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("mega_default.cu", "mega_guided.cu", "mega_train.cu",
           "closest_hit.cu", "bvh_build.cu", "deep_transport.cu",
           "sarsa_transport.cu", "sarsa_td.cu")
HEADERS = ("path_common.cuh",)
# -fmad=false: no a*b+c contraction, so the kernels round every f32
# operation as the torch twins' separate ops do on the card.  With
# contraction a ray origin or a Moller-Trumbore term moves by an ulp, a
# grazing hit flips now and then, and the flipped slot draws every later
# sample at other RNG iteration keys: at 32 spp 2.4% of the pixels of a
# 720x720 B3 frame then differ from the twin's.  Without it the frames
# are bit-identical, for about 16% more kernel time (PERF.md).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class MegaParams(ctypes.Structure):
    """Mirror of ``rlrpt::MegaParams`` in csrc/path_common.cuh, passed by
    value: every field is 4 bytes, so there is no padding to disagree on."""

    _fields_ = [
        ("seed", ctypes.c_uint32),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("n_pix", ctypes.c_int), ("spp", ctypes.c_int),
        ("max_bounces", ctypes.c_int), ("pix_mux", ctypes.c_int),
        ("n_slots", ctypes.c_int), ("n_tris", ctypes.c_int),
        ("russian_roulette", ctypes.c_int), ("rr_start_bounce", ctypes.c_int),
        ("focal", ctypes.c_float), ("env", ctypes.c_float),
        ("eps", ctypes.c_float), ("rr_min_prob", ctypes.c_float),
        ("cam_x", ctypes.c_float), ("cam_y", ctypes.c_float),
        ("cam_z", ctypes.c_float),
        ("cos_yaw_y", ctypes.c_float), ("sin_yaw_y", ctypes.c_float),
        ("cos_yaw_x", ctypes.c_float), ("sin_yaw_x", ctypes.c_float),
        ("n_sectors", ctypes.c_int), ("sector_grid", ctypes.c_int),
        ("uv_bins", ctypes.c_int), ("s_pad", ctypes.c_int),
        ("pdf_scale", ctypes.c_float), ("inv_gdir", ctypes.c_float),
    ]


class TrainParams(ctypes.Structure):
    """Mirror of ``TrainParams`` in csrc/mega_train.cu (4-byte fields)."""

    _fields_ = [
        ("n_cols", ctypes.c_int), ("max_iters", ctypes.c_int),
        ("radiance_threshold", ctypes.c_float), ("irr_scale", ctypes.c_float),
    ]


_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library() -> ctypes.CDLL:
    """The kernel library, compiled on first use."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    so = BUILD_DIR / f"librlrpt_mega_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = so.with_name(f"{so.stem}.{os.getpid()}")
        nvcc = _nvcc()
        objs, procs = [], []
        for src in SOURCES:
            obj = Path(f"{stem}.{src}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        tmp = Path(f"{stem}.so")
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.rlrpt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rlrpt_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


class Kernel:
    """One C entry point of the library, with its launch count.

    ``launches`` goes up by one for each launch that the C side accepted
    (its ``cudaGetLastError()`` was 0), and nowhere else.
    """

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0

    def launch(self, *args) -> None:
        lib = library()
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*args)
        if err != 0:
            msg = lib.rlrpt_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1
