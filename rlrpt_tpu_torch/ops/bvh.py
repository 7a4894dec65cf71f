"""The bounding-volume hierarchy that kernel B4 (closest hit, B4a-c) and
the culled kernel B1 walk.

``build_bvh`` builds one hierarchy per triangle table (the (T, 12) f32
rows of ``pack_triangles`` and ``megakernel.pack_scene``), on the table's
device and deterministically: a CPU table by the numpy build
(``_build_host``, the tree's definition), a CUDA table by the build
kernel ``csrc/bvh_build.cu`` (``KERNEL_BUILD``), which makes the same tree
bit for bit from the table on the card; ``build_bvh_plain`` is that
kernel's level steps in torch float64 on CPU tensors, for the tests.
The kernels walk it one ray a thread (``rlrpt::walk`` in
``csrc/path_common.cuh``: B4 in ``csrc/closest_hit.cu``, the culled B1
inside its slot loop in ``csrc/mega_default.cu``) and return what the
brute-force sweep returns: the same t, triangle index and material row.
``closest_hit_bvh_plain`` is the same walk in vectorised torch, for the
tests and B1's culled twin (``megakernel.walk_hit``).
This is the port's form of the JAX megakernel's AABB cull
(``rlrpt_tpu/ops/megakernel.py:411-472``), which skips whole
256-triangle chunks, since a TPU cannot walk a tree; the JAX closest-hit
kernels (B4) cull nothing.

Layout, decoded the same way by the kernel and by closest_hit_bvh_plain:

* ``nodes`` (N, 16) f32, one inner node a row (64 bytes), in breadth-first
  order with the root at row 0: ``[L.lo xyz, link L, L.hi xyz, 0, R.lo
  xyz, link R, R.hi xyz, 0]``, the two children's boxes and links.
* A link is int32 bits held in a float slot.  ``link >= 0``: the inner
  node at that row.  ``link < 0``: a leaf, ``~link = first << 3 | count``,
  the triangles at positions first .. first + count - 1 of the permuted
  order (count 1..LEAF_MAX).  ``EMPTY`` (-1, count 0) is no child; only a
  root over at most one triangle has one, and it is never entered.
* ``order`` (T,) int32: the original index of each permuted position;
  ``tris_sorted`` (T, 12) = ``tris[order]``, the same bits gathered.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from rlrpt_tpu_torch import _cuda
from rlrpt_tpu_torch.ops.megakernel import INF, hit_rows, mt_terms
from rlrpt_tpu_torch.utils import profiling

BINS = 16          # SAH bins over the centroids, per axis
LEAF_MAX = 4       # triangles a leaf holds at most
STACK = 64         # the kernels' per-thread stack (path_common.cuh kStack)
EMPTY = -1         # the link of no child
TINY = 1e-30       # |d| below this is clamped to TINY (megakernel.py:424-428)
# Ize, "Robust BVH Ray Traversal" (JCGT 2(2), 2013): the far distance
# scaled by 1 + 2 gamma_3, gamma_n = n u / (1 - n u), u = 2^-24; the
# kernel's kFarScale is the same double rounded to f32.
_U = 2.0 ** -24
FAR_SCALE = float(np.float32(1.0 + 2.0 * (3 * _U) / (1.0 - 3 * _U)))
# Box padding, as a fraction of the scene's extent E (its largest |corner
# coordinate|): every box grows by E * 2^-10 on each side before rounding
# outward to f32.  It suffices because the walk skips a box only when its
# near distance exceeds the best t so far (or its far one is below 0), so
# it loses a triangle only if that triangle's computed hit point o + t d
# lies outside a box that holds the triangle: the slab test rounds by a
# few ulps of the coordinates (below 2^-20 E for origins within 4E), and
# the f32 Moller-Trumbore t moves the hit point off the triangle by about
# 2^-21 |o - v0| / (sin(corner angle) cos(incidence)), below the margin
# for |o - v0| <= 4E while sin(corner angle) cos(incidence) >= 2^-9;
# below that, a loss also needs a second accepted hit within the margin
# of the first (a shared edge in another leaf), and the card tests count
# 0 differing rays over millions of camera, bounce and grazing rays.
MARGIN = 2.0 ** -10

BUILDS = 0   # build_bvh calls in this process


@dataclasses.dataclass(frozen=True)
class Bvh:
    """One triangle table's hierarchy, on the table's device (see the
    module docstring for the layout)."""

    nodes: torch.Tensor        # (N, 16) f32, N >= 1
    order: torch.Tensor        # (T,) int32
    tris_sorted: torch.Tensor  # (T, 12) f32
    depth: int                 # levels of inner nodes (the root's is 1)
    # the table it was built from; the launchers take only this one
    source: torch.Tensor = dataclasses.field(compare=False, repr=False)

    @property
    def n_tris(self) -> int:
        return self.order.shape[0]

    def check_source(self, tris: torch.Tensor) -> None:
        """Raises ValueError unless ``tris`` is the table this tree was
        built from (the launchers take no other)."""
        if self.source is not tris:
            raise ValueError("bvh was built from another triangle table: "
                             "pass the table given to build_bvh")


def _leaf(first, count):
    return ~((first << 3) | count)


def _round_out(lo, hi, margin):
    """f64 bounds grown by ``margin``, rounded outward to f32."""
    lo, hi = lo - margin, hi + margin
    lo32, hi32 = lo.astype(np.float32), hi.astype(np.float32)
    lo32 = np.where(lo32 > lo, np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32 < hi, np.nextafter(hi32, np.float32(np.inf)), hi32)
    return lo32, hi32


def _split(cen, tlo, thi, starts, counts):
    """Binned SAH over one level's nodes, each node's items contiguous
    (``starts``, ``counts``).  Returns per item whether it goes right.
    A node whose centroids all coincide splits by index."""
    k, m = counts.shape[0], cen.shape[0]
    node = np.repeat(np.arange(k), counts)
    cmin = np.minimum.reduceat(cen, starts)
    cext = np.maximum.reduceat(cen, starts) - cmin                  # (k, 3)
    scale = np.where(cext > 0, BINS / np.where(cext > 0, cext, 1.0), 0.0)
    b = np.clip(((cen - cmin[node]) * scale[node]).astype(np.int64), 0,
                BINS - 1)                                           # (m, 3)
    key = (node[:, None] * 3 + np.arange(3)) * BINS + b             # (m, 3)
    n_keys = k * 3 * BINS
    cnt = np.bincount(key.ravel(), minlength=n_keys).reshape(k, 3, BINS)
    blo = np.full((n_keys, 3), np.inf)
    bhi = np.full((n_keys, 3), -np.inf)
    for a in range(3):   # per-bin bounds: a sort and a segmented min/max
        by = np.argsort(key[:, a], kind="stable")
        k_by = key[by, a]
        first = np.flatnonzero(np.r_[True, k_by[1:] != k_by[:-1]])
        blo[k_by[first]] = np.minimum.reduceat(tlo[by], first)
        bhi[k_by[first]] = np.maximum.reduceat(thi[by], first)
    blo, bhi = blo.reshape(k, 3, BINS, 3), bhi.reshape(k, 3, BINS, 3)

    def area(lo, hi):
        e = np.maximum(hi - lo, 0.0)
        return (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2]
                + e[..., 2] * e[..., 0])

    n_l = np.cumsum(cnt, axis=2)[:, :, :-1]
    n_r = counts[:, None, None] - n_l
    a_l = area(np.minimum.accumulate(blo, axis=2),
               np.maximum.accumulate(bhi, axis=2))[:, :, :-1]
    a_r = area(np.minimum.accumulate(blo[:, :, ::-1], axis=2)[:, :, ::-1],
               np.maximum.accumulate(bhi[:, :, ::-1], axis=2)[:, :, ::-1]
               )[:, :, 1:]
    cost = np.where((n_l > 0) & (n_r > 0), n_l * a_l + n_r * a_r, np.inf)
    cost = cost.reshape(k, 3 * (BINS - 1))
    best = np.argmin(cost, axis=1)          # ties: lowest axis, then bin
    by_sah = np.isfinite(cost[np.arange(k), best])
    axis, cut = best // (BINS - 1), best % (BINS - 1)
    rank = np.arange(m) - starts[node]
    return np.where(by_sah[node], b[np.arange(m), axis[node]] > cut[node],
                    rank >= counts[node] // 2)


def _check_table(tris: torch.Tensor) -> None:
    if tris.dim() != 2 or tris.shape[1] != 12 or tris.dtype != torch.float32:
        raise ValueError(f"tris must be (T, 12) float32, got "
                         f"{tuple(tris.shape)} {tris.dtype}")


def _check_depth(depth: int) -> None:
    if depth > STACK:
        raise ValueError(f"BVH depth {depth} exceeds the kernel's stack of "
                         f"{STACK}")


def _root_row(lo32, hi32, n: int) -> np.ndarray:
    """The one row of a tree over n <= LEAF_MAX triangles: a leaf (or,
    for n = 0, no child) on the left, no child on the right."""
    row = np.zeros(16, np.float32)
    row[0:3], row[4:7] = lo32, hi32
    links = np.array([_leaf(0, n) if n else EMPTY, EMPTY], np.int32)
    row[[3, 11]] = links.view(np.float32)
    return row


def _build_host(tris: torch.Tensor) -> Bvh:
    """The numpy build, the tree's definition: a CPU table's build, and
    on the card the build that copies the table to the host (a sync) and
    the tree back, which the card tests hold the kernel against."""
    rows = tris.detach().cpu().numpy()
    n = rows.shape[0]
    v0 = rows[:, 0:3].astype(np.float64)
    # the corners the kernel's arithmetic sees: v0 and the exact sums
    # v0 + e1, v0 + e2 of the f32 row values (exact in float64); + 0.0
    # makes every -0 a +0, so no min or max depends on which zero it
    # meets first
    corners = np.stack([v0, v0 + rows[:, 4:7], v0 + rows[:, 8:11]],
                       axis=1) + 0.0
    tlo, thi = corners.min(axis=1), corners.max(axis=1)
    cen = ((corners[:, 0] + corners[:, 1]) + corners[:, 2]) / 3.0
    margin = float(np.abs(corners).max()) * MARGIN if n else 0.0

    levels, order = [], []
    if n <= LEAF_MAX:   # the root is one leaf and no child
        lo, hi = _round_out(tlo.min(axis=0) if n else np.zeros(3),
                            thi.max(axis=0) if n else np.zeros(3), margin)
        levels.append(_root_row(lo, hi, n)[None])
        order.append(np.arange(n))
    else:
        items = np.arange(n)
        starts, counts = np.array([0]), np.array([n])
        placed, next_node = 0, 1
        while counts.size:
            k = counts.size
            right = _split(cen[items], tlo[items], thi[items], starts, counts)
            node = np.repeat(np.arange(k), counts)
            items = items[np.lexsort((right, node))]   # stable: left, right
            n_right = np.bincount(node, weights=right, minlength=k).astype(
                np.int64)
            child = np.stack([counts - n_right, n_right], axis=1).ravel()
            c_starts = np.concatenate([[0], np.cumsum(child)[:-1]])
            lo, hi = _round_out(np.minimum.reduceat(tlo[items], c_starts),
                                np.maximum.reduceat(thi[items], c_starts),
                                margin)
            leaf = child <= LEAF_MAX
            first = placed + np.cumsum(np.where(leaf, child, 0)) - child
            inner_id = next_node + np.cumsum(~leaf) - 1
            link = np.where(leaf, _leaf(first, child), inner_id).astype(
                np.int32)
            row = np.zeros((k, 2, 8), np.float32)
            row[:, :, 0:3] = lo.reshape(k, 2, 3)
            row[:, :, 4:7] = hi.reshape(k, 2, 3)
            row[:, :, 3] = link.reshape(k, 2).view(np.float32)
            levels.append(row.reshape(k, 16))
            in_leaf = np.repeat(leaf, child)
            order.append(items[in_leaf])
            placed += int(in_leaf.sum())
            next_node += int((~leaf).sum())
            items = items[~in_leaf]
            counts = child[~leaf]
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(
                np.int64)
        _check_depth(len(levels))
    dev = tris.device
    perm = torch.from_numpy(np.concatenate(order).astype(np.int32)).to(dev)
    return Bvh(nodes=torch.from_numpy(np.concatenate(levels)).to(dev),
               order=perm, tris_sorted=tris[perm.long()].contiguous(),
               depth=len(levels), source=tris)


def _round_out_t(lo, hi, margin):
    """_round_out in torch."""
    lo, hi = lo - margin, hi + margin
    lo32, hi32 = lo.float(), hi.float()
    inf = torch.tensor(float("inf"))
    lo32 = torch.where(lo32.double() > lo, torch.nextafter(lo32, -inf), lo32)
    hi32 = torch.where(hi32.double() < hi, torch.nextafter(hi32, inf), hi32)
    return lo32, hi32


def _area_t(lo, hi):
    e = (hi - lo).clamp(min=0.0)
    return (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2]
            + e[..., 2] * e[..., 0])


def _scatter_min(rows, index, src):
    """(rows, 3) minima of src's rows by index (+inf where none): the
    kernel's atomic minima, exact in any order."""
    return torch.full((rows, 3), float("inf"), dtype=torch.float64
                      ).scatter_reduce(0, index, src, "amin")


def _scatter_max(rows, index, src):
    return torch.full((rows, 3), -float("inf"), dtype=torch.float64
                      ).scatter_reduce(0, index, src, "amax")


def _exclusive(v):
    out = torch.zeros_like(v)
    out[1:] = v.cumsum(0)[:-1]
    return out


def build_bvh_plain(tris: torch.Tensor, levels: list | None = None) -> Bvh:
    """The build kernel's level steps (csrc/bvh_build.cu) in torch float64
    on a CPU table: every reduction order-free (scatter min and max, bin
    counts), the children's boxes from the bins either side of a SAH cut,
    the stable partition and the breadth-first numbering by prefix sums.
    Returns the numpy build's tree bit for bit.  Nothing
    calls it on a path: the tests hold the kernel and the numpy build to
    it.  ``levels``: if a list, (inner nodes, their
    triangles) of each level are appended to it, the work a bound counts."""
    _check_table(tris)
    if tris.device.type != "cpu":
        raise ValueError(f"build_bvh_plain takes a CPU table, got "
                         f"{tris.device}")
    inf = float("inf")
    rows = tris.detach().double()
    n = rows.shape[0]
    v0 = rows[:, 0:3]
    c = torch.stack([v0, v0 + rows[:, 4:7], v0 + rows[:, 8:11]], 1) + 0.0
    tlo = torch.minimum(torch.minimum(c[:, 0], c[:, 1]), c[:, 2])
    thi = torch.maximum(torch.maximum(c[:, 0], c[:, 1]), c[:, 2])
    cen = ((c[:, 0] + c[:, 1]) + c[:, 2]) / 3.0
    margin = float(c.abs().max()) * MARGIN if n else 0.0
    nodes = torch.zeros((max(n - 1, 1), 16), dtype=torch.float32)
    order = torch.empty((n,), dtype=torch.int64)
    if n <= LEAF_MAX:
        lo, hi = ((tlo.amin(0), thi.amax(0)) if n
                  else (torch.zeros(3, dtype=torch.float64),) * 2)
        lo32, hi32 = _round_out_t(lo, hi, margin)
        nodes[0] = torch.from_numpy(_root_row(lo32.numpy(), hi32.numpy(), n))
        order = torch.arange(n)
        depth = n_nodes = 1
    else:
        ax = torch.arange(3)
        items, node = torch.arange(n), torch.zeros((n,), dtype=torch.int64)
        start, count = torch.tensor([0]), torch.tensor([n])
        k, m, base, placed, n_nodes, depth = 1, n, 0, 0, 1, 0
        while k:
            depth += 1
            if levels is not None:
                levels.append((k, m))
            ce, lo_i, hi_i = cen[items], tlo[items], thi[items]
            by3 = node[:, None].expand(m, 3)
            # the node's centroid bounds, its bins' counts and boxes
            cmin, cmax = _scatter_min(k, by3, ce), _scatter_max(k, by3, ce)
            cext = cmax - cmin
            scale = torch.where(cext > 0, BINS / torch.where(cext > 0, cext,
                                                             1.0), 0.0)
            b = ((ce - cmin[node]) * scale[node]).long().clamp(0, BINS - 1)
            key = ((node[:, None] * 3 + ax) * BINS + b).reshape(-1)
            n_bins = k * 3 * BINS
            cnt = torch.bincount(key, minlength=n_bins).reshape(k, 3, BINS)
            by_bin = key[:, None].expand(-1, 3)
            blo = _scatter_min(n_bins, by_bin, lo_i.repeat_interleave(3, 0)
                               ).reshape(k, 3, BINS, 3)
            bhi = _scatter_max(n_bins, by_bin, hi_i.repeat_interleave(3, 0)
                               ).reshape(k, 3, BINS, 3)
            # SAH per cut: the left bins' and the right bins' boxes
            n_l = cnt.cumsum(2)[:, :, :-1]
            n_r = count[:, None, None] - n_l
            pre_lo, pre_hi = blo.cummin(2).values, bhi.cummax(2).values
            suf_lo = blo.flip(2).cummin(2).values.flip(2)
            suf_hi = bhi.flip(2).cummax(2).values.flip(2)
            a_l, a_r = _area_t(pre_lo, pre_hi), _area_t(suf_lo, suf_hi)
            cost = torch.where((n_l > 0) & (n_r > 0),
                               n_l.double() * a_l[:, :, :-1]
                               + n_r.double() * a_r[:, :, 1:], inf
                               ).reshape(k, 3 * (BINS - 1))
            low = cost.amin(1)
            best = torch.where(cost == low[:, None], torch.arange(
                3 * (BINS - 1)), 3 * BINS).amin(1)   # ties: lowest (axis, cut)
            by_sah = torch.isfinite(low)
            axis, cut = best // (BINS - 1), best % (BINS - 1)
            # each triangle's side, and the stable partition by a prefix sum
            pos = torch.arange(m)
            s_j, c_j = start[node], count[node]
            right = torch.where(
                by_sah[node], b.gather(1, axis[node][:, None])[:, 0]
                > cut[node], pos - s_j >= c_j // 2)
            r_before = torch.zeros((m + 1,), dtype=torch.int64)
            r_before[1:] = right.long().cumsum(0)
            n_right = r_before[start + count] - r_before[start]
            rb = r_before[pos] - r_before[s_j]
            new_pos = torch.where(right, s_j + c_j - n_right[node] + rb,
                                  pos - rb)
            child = 2 * node + right.long()
            part = torch.empty_like(items)
            part[new_pos] = items
            child_at = torch.empty_like(items)
            child_at[new_pos] = child
            # the children's boxes: a SAH cut's are its bins' on either
            # side; a split by index's, its triangles' minima and maxima
            jk, c1 = torch.arange(k), (cut + 1).clamp(max=BINS - 1)
            sah2 = by_sah.repeat_interleave(2)[:, None]
            by_index = ~by_sah[node]
            by_child = child[by_index][:, None].expand(-1, 3)
            clo = torch.where(sah2, torch.stack(
                [pre_lo[jk, axis, cut], suf_lo[jk, axis, c1]], 1).reshape(
                    2 * k, 3), _scatter_min(2 * k, by_child, lo_i[by_index]))
            chi = torch.where(sah2, torch.stack(
                [pre_hi[jk, axis, cut], suf_hi[jk, axis, c1]], 1).reshape(
                    2 * k, 3), _scatter_max(2 * k, by_child, hi_i[by_index]))
            # the children: breadth-first numbers and leaf ranges by scans
            cc = torch.stack([count - n_right, n_right], 1).reshape(-1)
            leaf = cc <= LEAF_MAX
            first = placed + _exclusive(torch.where(leaf, cc, 0))
            inner_rank = _exclusive((~leaf).long())
            next_start = _exclusive(torch.where(leaf, 0, cc))
            link = torch.where(leaf, ~((first << 3) | cc),
                               n_nodes + inner_rank)
            lo32, hi32 = _round_out_t(clo, chi, margin)
            row = nodes[base:base + k].view(k, 2, 8)
            row[:, :, 0:3] = lo32.view(k, 2, 3)
            row[:, :, 4:7] = hi32.view(k, 2, 3)
            row[:, :, 3] = link.int().view(torch.float32).view(k, 2)
            # every triangle to its leaf's range or its inner child's
            j, side = child_at // 2, child_at % 2
            off = pos - (start[j] + side * (count[j] - n_right[j]))
            in_leaf = leaf[child_at]
            order[(first[child_at] + off)[in_leaf]] = part[in_leaf]
            k_next, m_next = int((~leaf).sum()), int(cc[~leaf].sum())
            items = torch.empty((m_next,), dtype=torch.int64)
            node = torch.empty((m_next,), dtype=torch.int64)
            dest = (next_start[child_at] + off)[~in_leaf]
            items[dest] = part[~in_leaf]
            node[dest] = inner_rank[child_at][~in_leaf]
            start, count = next_start[~leaf], cc[~leaf]
            base += k
            placed += int(cc[leaf].sum())
            n_nodes += k_next
            k, m = k_next, m_next
        _check_depth(depth)
    perm = order.to(torch.int32)
    return Bvh(nodes=nodes[:n_nodes], order=perm,
               tris_sorted=tris[order].contiguous(), depth=depth,
               source=tris)


# ---- the CUDA wrapper -----------------------------------------------------

# n_tris, tris, nodes, order, tris_sorted, info, work, stream
KERNEL_BUILD = _cuda.Kernel("rlrpt_bvh_build",
                            [ctypes.c_int] + [ctypes.c_void_p] * 7)


def launch_build(tris: torch.Tensor):
    """The build kernel on a contiguous CUDA table: returns (nodes (max(T
    - 1, 1), 16), order, tris_sorted, info), info (2,) int32 = (rows of
    nodes in use, depth), all filled on the card's current stream with no
    host sync.  Raises ValueError for a table not on a CUDA device."""
    _check_table(tris)
    if tris.device.type != "cuda":
        raise ValueError(f"no BVH build kernel for device {tris.device}")
    if not tris.is_contiguous():
        raise ValueError("tris must be contiguous")
    n = tris.shape[0]
    lib = _cuda.library()
    lib.rlrpt_bvh_workspace.argtypes = [ctypes.c_int]
    lib.rlrpt_bvh_workspace.restype = ctypes.c_longlong
    dev = tris.device
    nodes = torch.empty((max(n - 1, 1), 16), dtype=torch.float32, device=dev)
    order = torch.empty((n,), dtype=torch.int32, device=dev)
    tris_sorted = torch.empty((n, 12), dtype=torch.float32, device=dev)
    info = torch.empty((2,), dtype=torch.int32, device=dev)
    work = torch.empty((int(lib.rlrpt_bvh_workspace(n)),), dtype=torch.uint8,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL_BUILD.launch(n, tris.data_ptr(), nodes.data_ptr(),
                            order.data_ptr(), tris_sorted.data_ptr(),
                            info.data_ptr(), work.data_ptr(), stream)
    return nodes, order, tris_sorted, info


def build_bvh(tris: torch.Tensor) -> Bvh:
    """The hierarchy of a (T, 12) f32 triangle table (pack_triangles
    rows), on the table's device: a CPU table by the numpy build, a CUDA
    table by the build kernel (KERNEL_BUILD), with one small read of the
    tree's size back to the host and no copy of the table.  Raises
    ValueError if the tree is deeper than the kernel's stack, and for a
    table on another device."""
    global BUILDS
    _check_table(tris)
    if tris.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no BVH build for device {tris.device}")
    BUILDS += 1
    if tris.device.type == "cpu":
        return _build_host(tris)
    nodes, order, tris_sorted, info = launch_build(tris.contiguous())
    with profiling.host_sync("bvh_info", info):
        n_nodes, depth = info.tolist()
    _check_depth(depth)
    return Bvh(nodes=nodes[:n_nodes], order=order, tris_sorted=tris_sorted,
               depth=depth, source=tris)


def _slab(lo, hi, o, iv):
    """(near, far) of the rays' slab tests against boxes [lo, hi] (the
    last axis xyz): the kernel's box_near, whose min and max of three are
    exact in any order."""
    t1, t2 = (lo - o) * iv, (hi - o) * iv
    near = torch.minimum(t1, t2).amax(dim=-1)
    far = torch.maximum(t1, t2).amin(dim=-1) * FAR_SCALE
    return near, far


def closest_hit_bvh_plain(o: torch.Tensor, d: torch.Tensor, bvh: Bvh,
                          active_count, mat: torch.Tensor | None = None):
    """The kernel's walk in vectorised torch: every live ray takes one
    step at a time (an inner node's two box tests, a leaf's triangle
    tests, or the pops after them), with the kernel's slab test,
    nearer-child-first order, pop-time skip and tie rule (an equal t goes
    to the lower original index).

    Returns (t (R,), idx (R,) int32[, rows (R, 16)], visits (R,) int32,
    tests (R,) int32): closest_hit_plain's outputs, which these equal bit
    for bit, then each ray's inner-node visits (two box tests each) and
    ray-triangle tests.  Rays at index >= active_count are misses with no
    visits.  Used by the tests and B1's culled twin
    (megakernel.walk_hit)."""
    r = o.shape[0]
    live = max(min(int(active_count), r), 0)
    dev = o.device
    i32 = dict(dtype=torch.int32, device=dev)
    t_out = torch.full((r,), INF, dtype=torch.float32, device=dev)
    idx = torch.zeros((r,), **i32)
    visits = torch.zeros((r,), **i32)
    tests = torch.zeros((r,), **i32)
    ox, oy, oz = (o[:live, j] for j in range(3))
    dx, dy, dz = (d[:live, j] for j in range(3))
    o3 = o[:live, None, :]
    iv3 = 1.0 / torch.where(d[:live].abs() < TINY, TINY, d[:live])[:, None]
    nodes = bvh.nodes
    links = nodes[:, [3, 11]].contiguous().view(torch.int32).long()
    order, rows_t = bvh.order.long(), bvh.tris_sorted
    n_tris = bvh.n_tris

    depth = torch.arange(STACK, device=dev)
    link = torch.zeros((live,), dtype=torch.int64, device=dev)
    at_link = torch.ones((live,), dtype=torch.bool, device=dev)
    st_link = torch.zeros((live, STACK), dtype=torch.int64, device=dev)
    st_near = torch.zeros((live, STACK), dtype=torch.float32, device=dev)
    sp = torch.zeros((live,), dtype=torch.int64, device=dev)
    best_t = torch.full((live,), INF, dtype=torch.float32, device=dev)
    best = torch.full((live,), -1, dtype=torch.int64, device=dev)
    vis = torch.zeros((live,), **i32)
    tst = torch.zeros((live,), **i32)

    while bool(at_link.any()):
        inner = at_link & (link >= 0)
        nd = nodes[link.clamp(min=0)].view(-1, 2, 8)   # the two children
        ln = links[link.clamp(min=0)]
        near, far = _slab(nd[..., 0:3], nd[..., 4:7], o3, iv3)
        ok = (inner[:, None] & (ln != EMPTY) & (near <= far) & (far >= 0)
              & (near <= best_t[:, None]))
        (nl, nr), (ok_l, ok_r) = near.unbind(1), ok.unbind(1)
        vis += inner.int()
        both = ok_l & ok_r
        r_first = nr < nl
        push = both.nonzero()[:, 0]
        far_link = torch.where(r_first, ln[:, 0], ln[:, 1])
        st_link[push, sp[push]] = far_link[push]
        st_near[push, sp[push]] = torch.where(r_first, nl, nr)[push]
        sp = sp + both.long()
        nxt = torch.where(both & r_first, ln[:, 1],
                          torch.where(ok_l, ln[:, 0], ln[:, 1]))

        leaf = at_link & (link < 0)
        li = leaf.nonzero()[:, 0]
        if n_tris and li.numel():
            # the rays at a leaf test its (up to LEAF_MAX) triangles at once
            # (the others wait); the kernel's running rule, t < best or an
            # equal t at a lower index, keeps the (t, index) minimum
            code = ~link[li]
            first, count = code >> 3, code & 7
            on = torch.arange(LEAF_MAX, device=dev) < count[:, None]
            pos = torch.where(on, first[:, None] + torch.arange(
                LEAF_MAX, device=dev), 0)                     # (L, LEAF_MAX)
            rows = rows_t[pos]
            tp, det, _, _, valid = mt_terms(
                *(a[li][:, None] for a in (ox, oy, oz, dx, dy, dz)),
                lambda c: rows[..., c])
            t = torch.where(on & valid, tp / det, INF)
            t_min = t.min(dim=1).values
            orig = torch.where(t == t_min[:, None], order[pos],
                               torch.iinfo(torch.int64).max).min(dim=1).values
            bt, bi = best_t[li], best[li]
            take = (t_min < INF) & ((t_min < bt) | ((t_min == bt)
                                                     & (orig < bi)))
            best_t[li] = torch.where(take, t_min, bt)
            best[li] = torch.where(take, orig, bi)
            tst[li] += count.int()
        link = torch.where(ok_l | ok_r, nxt, link)
        popping = leaf | (inner & ~(ok_l | ok_r))
        at_link = at_link & ~popping
        # pop until an entry's near is within the best t, or none is left:
        # the topmost such entry is taken and those above it dropped
        pl = popping.nonzero()[:, 0]
        if pl.numel():
            ok = (depth < sp[pl, None]) & (st_near[pl] <= best_t[pl, None])
            top = torch.where(ok, depth, -1).max(dim=1).values
            found = top >= 0
            top = top.clamp(min=0)
            link[pl] = torch.where(found, st_link[pl, top], link[pl])
            sp[pl] = top
            at_link[pl] = found

    hit = best_t < INF
    t_out[:live] = best_t
    idx[:live] = torch.where(hit, best, 0).to(torch.int32)
    visits[:live], tests[:live] = vis, tst
    if mat is None:
        return t_out, idx, visits, tests
    return t_out, idx, hit_rows(mat, t_out, idx), visits, tests
