"""The bounding-volume hierarchy that kernel B4 (closest hit, B4a-c) and
the culled kernel B1 walk.

``build_bvh`` builds one hierarchy per triangle table (the (T, 12) f32
rows of ``pack_triangles`` and ``megakernel.pack_scene``), on the host
with numpy and deterministically, so the CPU tests and the card get the
same tree.  The kernels walk it one ray a thread (``rlrpt::walk`` in
``csrc/path_common.cuh``: B4 in ``csrc/closest_hit.cu``, the culled B1
inside its slot loop in ``csrc/mega_default.cu``) and return what the
brute-force sweep returns: the same t, triangle index and material row.
``closest_hit_bvh_plain`` is the same walk in vectorised torch, for the
tests, chip_smoke.py and B1's culled twin (``megakernel.walk_hit``).
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

import dataclasses

import numpy as np
import torch

from rlrpt_tpu_torch.ops.megakernel import INF, hit_rows, mt_terms

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
# of the first (a shared edge in another leaf), and chip_smoke.py counts
# 0 differing rays over millions of camera, bounce and grazing rays.
MARGIN = 2.0 ** -10

BUILDS = 0   # build_bvh calls in this process (chip_smoke.py reads it)


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


def build_bvh(tris: torch.Tensor) -> Bvh:
    """The hierarchy of a (T, 12) f32 triangle table (pack_triangles
    rows), on the table's device.  Copies the table to the host once (a
    device sync), so callers build once a frame.  Raises ValueError if
    the tree is deeper than the kernel's stack."""
    global BUILDS
    if tris.dim() != 2 or tris.shape[1] != 12 or tris.dtype != torch.float32:
        raise ValueError(f"tris must be (T, 12) float32, got "
                         f"{tuple(tris.shape)} {tris.dtype}")
    BUILDS += 1
    rows = tris.detach().cpu().numpy()
    n = rows.shape[0]
    v0 = rows[:, 0:3].astype(np.float64)
    # the corners the kernel's arithmetic sees: v0 and the exact sums
    # v0 + e1, v0 + e2 of the f32 row values (exact in float64)
    corners = np.stack([v0, v0 + rows[:, 4:7], v0 + rows[:, 8:11]], axis=1)
    tlo, thi = corners.min(axis=1), corners.max(axis=1)
    cen = corners.sum(axis=1) / 3.0
    margin = float(np.abs(corners).max()) * MARGIN if n else 0.0

    levels, order = [], []
    if n <= LEAF_MAX:   # the root is one leaf and no child
        lo, hi = _round_out(tlo.min(axis=0) if n else np.zeros(3),
                            thi.max(axis=0) if n else np.zeros(3), margin)
        row = np.zeros(16, np.float32)
        row[0:3], row[4:7] = lo, hi
        links = np.array([_leaf(0, n) if n else EMPTY, EMPTY], np.int32)
        row[[3, 11]] = links.view(np.float32)
        levels.append(row[None])
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
        if len(levels) > STACK:
            raise ValueError(f"BVH depth {len(levels)} exceeds the kernel's "
                             f"stack of {STACK}")
    dev = tris.device
    perm = torch.from_numpy(np.concatenate(order).astype(np.int32)).to(dev)
    return Bvh(nodes=torch.from_numpy(np.concatenate(levels)).to(dev),
               order=perm, tris_sorted=tris[perm.long()].contiguous(),
               depth=len(levels), source=tris)


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
    visits.  Used by the tests, chip_smoke.py and B1's culled twin
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
