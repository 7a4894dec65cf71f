"""The closest-hit kernels of the wavefront integrators (counterpart of
``rlrpt_tpu/ops/intersect_pallas.py``; the name is kept so the two are
easy to pair).

Three TPU kernels become one CUDA kernel, ``csrc/closest_hit.cu``, with
three launchers whose launches are counted apart:

* ``closest_hit_packed`` (B4b): exact f32 Moller-Trumbore, t and index;
* ``closest_hit_packed_mxu`` (B4c): on the TPU the same output from
  compensated-bf16 MXU operands; here it is B4b's output, computed
  exactly;
* ``closest_hit_mat_mxu`` (B4a): plus the hit's 16-float material row,
  which the TPU fetched with a one-hot matmul and which is a load here.

Tables: ``pack_triangles`` gives the (T, 12) f32 rows [v0, 0, e1, 0, e2,
0] the megakernels use (no padding: the kernel masks the ragged triangle
tile, and the bf16 hi/lo split of the TPU's MXU table is gone);
``pack_scene_mxu`` adds the (T, 16) f32 material rows [normal, diffuse,
emission, is_light, luminance, class id, 0 x 4].

``active_count``: rays at index >= count are skipped and come back as a
miss (t = INF, index 0, zero row), as the JAX docstring's contract says.
The JAX kernels skip whole 512-ray tiles instead, so rays past the count
inside a live tile get real hits there.  On the card the count is read
from a device int32 tensor, so the wavefront's high-water mark never makes
the host wait.

On the card the kernel walks a bounding-volume hierarchy of the table
(``ops/bvh.py``): each launcher takes the frame's ``bvh=``, built once
per table by the caller, and builds one itself when given none (on the
card by the build kernel, with one small read of the tree's size, and so
a sync).  The answer is the brute-force sweep's
bit for bit.  Each launcher runs the plain twin ``closest_hit_plain``
(built on ``ops.megakernel.closest_hit_mt``, the brute force) for CPU
tensors, where ``bvh`` is not used, and the kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from rlrpt_tpu_torch import _cuda
from rlrpt_tpu_torch.ops.bvh import Bvh, build_bvh
from rlrpt_tpu_torch.ops.intersect import Hit
from rlrpt_tpu_torch.ops.megakernel import (INF, closest_hit_mt, hit_rows,
                                             pack_scene)
from rlrpt_tpu_torch.scene.scene import AREA_LIGHT, NOTHING, SURFACE, Scene
from rlrpt_tpu_torch.utils import profiling

# The plain twin holds ~20 (rays, T) float32 temporaries per block of rays;
# a block has at most PLAIN_RAY_TILE rays and PLAIN_TILE_PAIRS (ray,
# triangle) pairs, so its memory stays bounded at thousands of triangles.
PLAIN_RAY_TILE = 65536
PLAIN_TILE_PAIRS = 1 << 24


def pack_triangles(scene: Scene) -> torch.Tensor:
    """(T, 12) f32 triangle rows for the closest-hit kernels."""
    return pack_scene(scene)[0]


def pack_scene_mxu(scene: Scene, tri_class: torch.Tensor | None = None):
    """(tris (T, 12), mat (T, 16)) f32 for closest_hit_mat_mxu: material
    rows 0-2 normal, 3-5 diffuse_c, 6-8 emission, 9 is_light,
    10 luminance, 11 ``tri_class`` (integer normal-class ids, exact in f32
    below 2^24; zeros when not given), 12-15 zeros."""
    tris, mat = pack_scene(scene)
    mat = mat.clone()   # pack_scene's tables are shared
    mat[:, 11] = 0.0
    if tri_class is not None:
        if tri_class.shape != (scene.n_triangles,):
            raise ValueError(f"tri_class must be ({scene.n_triangles},), "
                             f"got {tuple(tri_class.shape)}")
        if scene.n_triangles and int(tri_class.max()) >= 1 << 24:
            raise ValueError("class ids must be below 2^24 to stay exact "
                             "in the f32 material row")
        mat[:, 11] = tri_class.to(mat.device, torch.float32)
    return tris, mat


def _count(active_count, n_rays: int) -> int:
    return max(min(int(active_count), n_rays), 0)


def closest_hit_plain(o: torch.Tensor, d: torch.Tensor, tris: torch.Tensor,
                      active_count, mat: torch.Tensor | None = None):
    """Plain torch twin of the closest-hit kernel: (t (R,), idx (R,) i32)
    and, with ``mat``, the (R, 16) material rows."""
    r = o.shape[0]
    live = _count(active_count, r) if tris.shape[0] else 0   # T = 0: misses
    t = torch.full((r,), INF, dtype=torch.float32, device=o.device)
    idx = torch.zeros((r,), dtype=torch.int32, device=o.device)
    tile = min(PLAIN_RAY_TILE,
               max(1, PLAIN_TILE_PAIRS // max(1, tris.shape[0])))
    for s in range(0, live, tile):
        e = min(s + tile, live)
        bt, tri = closest_hit_mt(o[s:e, 0], o[s:e, 1], o[s:e, 2], d[s:e, 0],
                                 d[s:e, 1], d[s:e, 2], tris)[:2]
        hit = bt < INF
        t[s:e] = bt
        idx[s:e] = torch.where(hit, tri, 0).to(torch.int32)
    if mat is None:
        return t, idx
    return t, idx, hit_rows(mat, t, idx)


def _check(o, d, tris, mat):
    r = o.shape[0]
    if o.shape != (r, 3) or d.shape != (r, 3):
        raise ValueError(f"o and d must be (R, 3), got {tuple(o.shape)} and "
                         f"{tuple(d.shape)}")
    tables = (("tris", tris, 12),) + ((("mat", mat, 16),) if mat is not None
                                       else ())
    for name, a, cols in (("o", o, 3), ("d", d, 3)) + tables:
        if a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if a.device != o.device:
            raise ValueError(f"{name} must be on the rays' device")
        if a.dim() != 2 or a.shape[1] != cols:
            raise ValueError(f"{name} must have {cols} columns, got "
                             f"{tuple(a.shape)}")
    if mat is not None and mat.shape[0] != tris.shape[0]:
        raise ValueError("tris and mat must have one row per triangle")
    if tris.data_ptr() % 16 or (mat is not None and mat.data_ptr() % 16):
        raise ValueError("tris and mat must be 16-byte aligned (float4 loads)")


_ARGS = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11
KERNEL_F32 = _cuda.Kernel("rlrpt_closest_hit", _ARGS)   # B4b
KERNEL_MXU = _cuda.Kernel("rlrpt_closest_hit", _ARGS)   # B4c
KERNEL_MAT = _cuda.Kernel("rlrpt_closest_hit", _ARGS)   # B4a
# The brute-force sweep, kept as the card's same-width reference; not B4.
KERNEL_SWEEP = _cuda.Kernel("rlrpt_closest_hit_sweep",
                            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9)


def _launch_setup(o, active_count, mat):
    """The device count and the outputs t, idx and (with ``mat``) rows."""
    r = o.shape[0]
    if isinstance(active_count, torch.Tensor):
        count = active_count.reshape(1).to(o.device, torch.int32)
    else:
        count = torch.tensor([_count(active_count, r)], dtype=torch.int32,
                             device=o.device)
    t = torch.empty((r,), dtype=torch.float32, device=o.device)
    idx = torch.empty((r,), dtype=torch.int32, device=o.device)
    rows = (torch.empty((r, 16), dtype=torch.float32, device=o.device)
            if mat is not None else None)
    return count, t, idx, rows


def _closest_hit(kernel: _cuda.Kernel, o, d, tris, active_count, mat=None,
                 bvh: Bvh | None = None):
    """The launchers' body."""
    _check(o, d, tris, mat)
    if bvh is not None:
        bvh.check_source(tris)
    if o.device.type == "cpu":
        return closest_hit_plain(o, d, tris, active_count, mat)
    if o.device.type != "cuda":
        raise ValueError(f"no kernel for device {o.device}")
    if bvh is None:
        bvh = build_bvh(tris)
    r = o.shape[0]
    count, t, idx, rows = _launch_setup(o, active_count, mat)
    if r:
        with torch.cuda.device(o.device):
            stream = torch.cuda.current_stream().cuda_stream
            kernel.launch(r, bvh.nodes.shape[0], count.data_ptr(),
                          o.data_ptr(), d.data_ptr(), bvh.nodes.data_ptr(),
                          bvh.tris_sorted.data_ptr(), bvh.order.data_ptr(),
                          None if mat is None else mat.data_ptr(),
                          t.data_ptr(), idx.data_ptr(),
                          None if rows is None else rows.data_ptr(), stream)
    return (t, idx) if mat is None else (t, idx, rows)


def closest_hit_sweep(o: torch.Tensor, d: torch.Tensor, tris: torch.Tensor,
                      active_count, mat: torch.Tensor | None = None):
    """The brute-force closest-hit kernel (every ray against every
    triangle, in 256-triangle shared-memory tiles), which the BVH walk
    replaced.  No path calls it and its launches do not count as B4's:
    the card tests alone use it, as a full-width reference on the same
    card.  Returns closest_hit_packed's
    outputs, and the rows with ``mat``; the plain twin on the CPU."""
    _check(o, d, tris, mat)
    if o.device.type == "cpu":
        return closest_hit_plain(o, d, tris, active_count, mat)
    if o.device.type != "cuda":
        raise ValueError(f"no kernel for device {o.device}")
    r = o.shape[0]
    count, t, idx, rows = _launch_setup(o, active_count, mat)
    if r:
        with torch.cuda.device(o.device):
            stream = torch.cuda.current_stream().cuda_stream
            KERNEL_SWEEP.launch(r, tris.shape[0], count.data_ptr(),
                                o.data_ptr(), d.data_ptr(), tris.data_ptr(),
                                None if mat is None else mat.data_ptr(),
                                t.data_ptr(), idx.data_ptr(),
                                None if rows is None else rows.data_ptr(),
                                stream)
    return (t, idx) if mat is None else (t, idx, rows)


def closest_hit_packed(o: torch.Tensor, d: torch.Tensor, tris: torch.Tensor,
                       active_count, bvh: Bvh | None = None):
    """Closest hit for rays o, d (R, 3) against pack_triangles rows (B4b).
    ``active_count``: int or device int32 tensor; rays at index >= count
    are skipped (INF, 0).  ``bvh``: build_bvh(tris), built once a frame.
    Returns (t (R,), tri_idx (R,) int32)."""
    return _closest_hit(KERNEL_F32, o, d, tris, active_count, bvh=bvh)


def closest_hit_packed_mxu(o: torch.Tensor, d: torch.Tensor,
                           tris: torch.Tensor, active_count,
                           bvh: Bvh | None = None):
    """closest_hit_packed under the JAX MXU launcher's name (B4c): the
    same exact output, counted apart."""
    return _closest_hit(KERNEL_MXU, o, d, tris, active_count, bvh=bvh)


def closest_hit_mat_mxu(o: torch.Tensor, d: torch.Tensor, tris: torch.Tensor,
                        mat: torch.Tensor, active_count,
                        bvh: Bvh | None = None):
    """Closest hit plus material row (B4a) over pack_scene_mxu's tables.
    Returns (t (R,), tri_idx (R,) int32, mat (R, 16) f32); a miss or a
    skipped ray has a zero row.  While a profiler records, the span
    ``closest_hit_mat_mxu.launch`` holds the checks, the outputs and the
    launch (or the twin on the CPU)."""
    with profiling.span("closest_hit_mat_mxu.launch"):
        return _closest_hit(KERNEL_MAT, o, d, tris, active_count, mat,
                            bvh=bvh)


def _hit_record(o, d, scene: Scene, t, tri, normal):
    missed = t >= INF
    hit_type = torch.where(
        missed, NOTHING,
        torch.where(tri >= scene.n_surfaces, AREA_LIGHT, SURFACE)).to(
            torch.int32)
    t_safe = torch.where(missed, torch.zeros_like(t), t)
    return Hit(t=t, tri=tri, hit_type=hit_type,
               position=o + t_safe[:, None] * d, normal=normal)


def closest_hit_pallas(o: torch.Tensor, d: torch.Tensor, scene: Scene,
                       tris: torch.Tensor | None = None,
                       active_count=None, bvh: Bvh | None = None) -> Hit:
    """``ops.intersect.closest_hit`` through the B4b kernel: the same Hit
    record.  ``tris``: pack_triangles(scene), and ``bvh``: build_bvh(tris),
    each made once per frame."""
    if tris is None:
        tris = pack_triangles(scene)
    if active_count is None:
        active_count = o.shape[0]
    t, tri = closest_hit_packed(o, d, tris, active_count, bvh)
    tri = tri.long()
    return _hit_record(o, d, scene, t, tri, scene.normal[tri])


def material_rows(scene: Scene, tri: torch.Tensor) -> torch.Tensor:
    """(N, 16) material rows by per-field gathers, in pack_scene_mxu's
    layout with no class ids."""
    n = tri.shape[0]
    return torch.cat([
        scene.normal[tri], scene.diffuse_c[tri], scene.emission[tri],
        (tri >= scene.n_surfaces)[:, None].float(),
        scene.luminance[tri][:, None],
        torch.zeros((n, 5), dtype=torch.float32, device=tri.device)], dim=1)


def closest_hit_pallas_mat(o: torch.Tensor, d: torch.Tensor, scene: Scene,
                           tris: torch.Tensor, mat: torch.Tensor,
                           active_count=None, bvh: Bvh | None = None):
    """closest_hit_pallas that also returns the material row, through the
    B4a kernel.  Returns (Hit, mat (N, 16)); Hit.normal comes from the row
    (zeros for misses)."""
    if active_count is None:
        active_count = o.shape[0]
    t, tri, rows = closest_hit_mat_mxu(o, d, tris, mat, active_count, bvh)
    return _hit_record(o, d, scene, t, tri.long(), rows[:, 0:3]), rows
