"""Plain expected SARSA over radiance volumes: the reference engine's
mode 1 (reinforcement_path_tracing.cu, radiance_map.cu, radiance_volume.cu)
one torch or numpy operation at a time, in the dtype ``ft`` the caller
states (float32 as the configurations state it, bfloat16 for the
benchmark's control).

* the volume set (radiance_map.cu:60-84): floor(area / area_per_sample)
  volumes on each surface triangle, its area in float32; the points drawn
  from numpy's generator at the configuration's seed, in float64 from the
  float32 vertices, then rounded to float32; each volume takes its
  triangle's normal and luminance; its frame (T, N, B) is the shading
  frame of the normal (hemisphere_helpers.cu:31-63); Q starts at the
  initial radiance, the visits at 0 (radiance_volume.cu:49-89);
* the nearest volume (radiance_map.cu:150-203): brute force over every
  volume, a block of queries at a time, keeping only volumes whose normal
  equals the query's exactly, within the reach; none there gives volume
  0 (radiance_map.cu:163-166);
* the TD target of a transition into a vertex (radiance_map.cu:111-146):
  the previous surface's luminance / pi times the environment on a miss,
  the light's luminance on a light, the hit volume's irradiance estimate
  on a surface;
* the update (radiance_volume.cu:283-301): each target of an entry in
  turn, visits + 1, a = 1 / (1 + visits), Q <- (1 - a) Q + a target;
* the irradiance estimate sum_s cos_s (lum / pi) Q_s x 2 pi / S
  (radiance_volume.cu:49-69, 305-307);
* the sector draw (radiance_volume.cu:192-244): the count of CDF entries
  below the uniform, the last sector taking the rest; pdf = RHO x
  (p_sector / GRID_RHO); the direction is Chiu's map of the sector's
  jittered grid point about the normal;
* the CDF rebuild (radiance_volume.cu:149-188): the running sum of
  Q cos(theta) over its total (plus 1e-10).

Departures from the reference engine, each the port's too:

* the points: the engine rejection-samples a1 + a2 <= 1
  (triangle.cu:30-64); here every pair is drawn at once and one past the
  diagonal folds to (1 - a1, 1 - a2), the same distribution;
* the initial CDF is the uniform (i + 1) / S, not the engine's ramp
  i / S, whose last entry lets its search fail on the first frame;
* a batch of updates is one wavefront iteration, and an entry's Q is
  clamped at the radiance threshold once after its batch; the engine
  clamps after each of its atomic updates;
* the port finds the nearest volume in an answer table: per cell of a
  uniform grid and per normal class, the nearest same-class volume to the
  cell's centre (``table_centres`` gives the centre of a query's cell), in
  a reach wider than the engine's sqrt(0.003), with no fallback to volume
  0; ``allowance`` bounds how much farther than the query's nearest
  volume such an answer may lie, from the cell size the configuration
  states;
* the direction is drawn in the hit normal's frame, and the tracer runs
  on the port's regenerative slot wavefront (``transport``: a finished
  sample is banked into its slot's row, the next one starts at once).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import neural_q as nqr
from benchmark.reference import pathtrace as pt

#: Distances within this of each other are ties (float32 distances of
#: points within a few units of the origin).
TIE = 1e-5

# ---- the volume set ---------------------------------------------------------

def volume_set(tables, area_per_sample: float, grid: int,
               initial_radiance: float, seed: int, device="cpu",
               ft=torch.float32) -> dict:
    """The volumes of the scene ``tables`` (``reference/scenes.py``):
    ``position``, ``normal``, ``frame`` (V, 3, 3) rows (T, N, B),
    ``surface_lum``, ``q``, ``visits`` (int64), ``cdf`` and ``tri``."""
    ns = tables.n_surfaces
    v0, v1, v2 = tables.v0[:ns], tables.v1[:ns], tables.v2[:ns]
    area = np.float32(0.5) * np.linalg.norm(np.cross(v1 - v0, v2 - v0),
                                            axis=-1)
    counts = np.floor(area / np.float32(area_per_sample)).astype(np.int64)
    tri = np.repeat(np.arange(ns), counts)
    a = np.random.default_rng(seed).random((len(tri), 2), dtype=np.float64)
    fold = a[:, 0] + a[:, 1] > 1.0
    a[fold] = 1.0 - a[fold]
    d0, d1, d2 = (x.astype(np.float64)[tri] for x in (v0, v1, v2))
    pos = (d0 + a[:, :1] * (d1 - d0) + a[:, 1:2] * (d2 - d0)).astype(
        np.float32)
    as_t = lambda x: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(x, np.float32), device=device).to(ft)
    normal = as_t(tables.normal[tri])
    (tx, ty, tz), (bx, by, bz) = pt.frame_tb(normal[:, 0], normal[:, 1],
                                             normal[:, 2])
    frame = torch.stack([torch.stack([tx, ty, tz], -1), normal,
                         torch.stack([bx, by, bz], -1)], dim=-2)
    v, s = len(tri), grid * grid
    return {"position": as_t(pos), "normal": normal, "frame": frame,
            "surface_lum": as_t(tables.luminance[tri]),
            "q": torch.full((v, s), initial_radiance, dtype=ft,
                            device=device),
            "visits": torch.zeros((v, s), dtype=torch.int64, device=device),
            "cdf": (torch.arange(1, s + 1, dtype=ft, device=device)
                    / s).expand(v, s).contiguous(),
            "tri": torch.as_tensor(tri, device=device)}


def class_ids(tables) -> np.ndarray:
    """(T,) each triangle's normal class: the rank of its normal among
    the scene's distinct normals (exact float32 equality)."""
    _, inv = np.unique(np.asarray(tables.normal, np.float32), axis=0,
                       return_inverse=True)
    return inv.reshape(-1).astype(np.int64)


# ---- the nearest volume -----------------------------------------------------

def nearest(qpos, qnormal, vpos, vnormal, reach: float | None = None,
            ft=torch.float32):
    """(index (N,) int64, distance (N,)) of the nearest volume whose normal
    equals the query's, by brute force; volume 0 at distance inf where
    none lies within ``reach`` (every distance counts with None)."""
    n, v = qpos.shape[0], vpos.shape[0]
    idx = torch.zeros((n,), dtype=torch.int64, device=qpos.device)
    dist = torch.full((n,), math.inf, dtype=ft, device=qpos.device)
    vpos, vnormal = vpos.to(ft), vnormal.to(torch.float32)
    block = max(1, (1 << 24) // max(v, 1))
    for i in range(0, n, block):
        q = qpos[i:i + block].to(ft)
        diff = q[:, None, :] - vpos[None, :, :]
        d = torch.sqrt((diff * diff).sum(dim=-1))
        same = (qnormal[i:i + block, None, :].to(torch.float32)
                == vnormal[None, :, :]).all(dim=-1)
        d = torch.where(same, d, math.inf)
        best, j = d.min(dim=-1)
        found = best <= reach if reach is not None else best < math.inf
        idx[i:i + block] = torch.where(found, j, 0)
        dist[i:i + block] = torch.where(found, best, math.inf)
    return idx, dist


def table_centres(qpos, origin, inv_cell, dims) -> torch.Tensor:
    """The centre of the answer table's cell that holds each query: the
    cell (qpos - origin) x inv_cell truncated, each axis clamped into the
    grid's ``dims``."""
    f = (qpos.to(torch.float32) - origin) * inv_cell
    cell = torch.stack([torch.clamp(f[:, a], 0.0, n - 1).long()
                        for a, n in enumerate(dims)], dim=-1)
    return origin + (cell.to(torch.float32) + 0.5) / inv_cell


def allowance(qpos, vpos, cell: float, margin: float) -> torch.Tensor:
    """(N,) how much farther than its nearest volume a query's answer may
    lie under a table that answers at cell centres, in cells of side
    ``cell`` over the volumes' box widened by ``margin``: the centre lies
    within half a cell diagonal h of the query (or of its clamp into the
    box, a distance e away), so its nearest is at most d + h + e from it
    and at most d + 2 (h + e) from the query, d the query's nearest."""
    v, q = vpos.to(torch.float32), qpos.to(torch.float32)
    lo = v.min(dim=0).values - margin
    hi = v.max(dim=0).values + margin
    out = torch.linalg.vector_norm(q - torch.maximum(torch.minimum(q, hi),
                                                     lo), dim=-1)
    return math.sqrt(3.0) * cell + 2.0 * out


def excess(answer, points, qnormal, vpos, vnormal) -> torch.Tensor:
    """(N,) how much farther each answer lies from its point than the
    nearest volume of the point's normal: inf for an answer of another
    normal, 0 where no volume shares the point's normal (the table's
    fallback: any answer)."""
    _, best = nearest(points, qnormal, vpos, vnormal)
    pos = vpos.to(torch.float32)[answer]
    d = torch.sqrt(((points.to(torch.float32) - pos) ** 2).sum(dim=-1))
    same = (vnormal.to(torch.float32)[answer]
            == qnormal.to(torch.float32)).all(dim=-1)
    out = torch.where(same, d - best, math.inf)
    return torch.where(torch.isfinite(best), out, 0.0)


def admissible(answer, points, qnormal, vpos, vnormal, slack=0.0,
               tol: float = TIE) -> torch.Tensor:
    """(N,) bool: whether each answer lies within ``slack`` (a number or
    (N,)) of the nearest volume of its point's normal, ties within
    ``tol``."""
    return excess(answer, points, qnormal, vpos, vnormal) <= slack + tol


# ---- learning ---------------------------------------------------------------

def irradiance(q, surface_lum, grid: int, ft=torch.float32) -> torch.Tensor:
    """(V,) each volume's irradiance estimate from its Q row."""
    cos = pt.sector_cos(grid, q.device, ft)
    s = grid * grid
    acc = torch.sum(q.to(ft) * cos, dim=-1) * (surface_lum.to(ft) / math.pi)
    return acc * (2.0 * math.pi / s)


def td_targets(cur_brdf, missed, hit_light, lum, irr_next, env: float,
               ft=torch.float32) -> torch.Tensor:
    """The target of each lane's pending transition: brdf x the
    environment on a miss, x the light's luminance on a light, x the
    irradiance estimate at the hit's volume on a surface."""
    brdf, lum, irr_next = cur_brdf.to(ft), lum.to(ft), irr_next.to(ft)
    return torch.where(missed, brdf * env,
                       torch.where(hit_light, brdf * lum, brdf * irr_next))


def update(q, visits, entries, targets, threshold: float,
           ft=torch.float32):
    """(q, visits, touched) after the targets, flat entries
    volume x S + sector, applied in lane order: each target in turn adds
    one visit and moves Q by 1 / (1 + visits) towards it; a touched entry
    is then clamped at ``threshold``.  ``touched`` lists each entry once."""
    shape = q.shape
    q = q.to(ft).reshape(-1).clone()
    visits = visits.to(torch.int64).reshape(-1).clone()
    order = torch.sort(entries, stable=True).indices
    e, t = entries[order], targets[order].to(ft)
    touched, counts = torch.unique_consecutive(e, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(e.shape[0], device=e.device) - torch.repeat_interleave(
        starts, counts)
    for j in range(int(counts.max()) if counts.numel() else 0):
        at = rank == j
        ej, tj = e[at], t[at]
        visits[ej] += 1
        a = 1.0 / (1.0 + visits[ej].to(ft))
        q[ej] = (1.0 - a) * q[ej] + a * tj
    q[touched] = torch.clamp(q[touched], min=threshold)
    return q.reshape(shape), visits.reshape(shape), touched


def rebuild_cdf(q, grid: int, distribution_threshold: float = 0.0,
                ft=torch.float32) -> torch.Tensor:
    """(V, S) each volume's CDF over its sectors of Q cos(theta)."""
    cos = pt.sector_cos(grid, q.device, ft)
    w = torch.clamp(q.to(ft) * cos, min=distribution_threshold)
    total = 1e-10 + torch.sum(w, dim=-1, keepdim=True)
    return torch.cumsum(w / total, dim=-1)


# ---- the step ---------------------------------------------------------------

def sample(rows, r, u, normal, grid: int, ft=torch.float32):
    """(sector (N,) int64, pdf (N,), direction (N, 3)) from CDF rows
    (N, S), the uniforms r (N, 1) and the jitter u (N, 2) about
    ``normal``."""
    s = grid * grid
    rows, r = rows.to(ft), r.to(ft)
    sector = torch.clamp((rows < r).sum(dim=-1), max=s - 1)
    pick = lambda j: rows.gather(1, j[:, None])[:, 0]  # noqa: E731
    hi = torch.where(sector == s - 1, 1.0, pick(sector))
    lo = torch.where(sector > 0, pick(torch.clamp(sector - 1, min=0)), 0.0)
    pdf = nqr.RHO * ((hi - lo) / (1.0 / s))
    return sector, pdf, nqr.direction(sector, u.to(ft), normal.to(ft), grid)


def transport(state: dict, t, tri, mrow, next_vol, sector, pdf, new_d,
              u_pix, n_surfaces: int, fr: pt.Frame, cam: tuple, w0: int,
              pix_mux: int, ft=torch.float32) -> dict:
    """What a step makes of its hits once the sector is drawn, with no
    Russian roulette: the radiance gathered, the throughput carried, a
    finished sample banked into its slot's row for its pixel, and the
    slot's next sample (or, after the last, the slot's next pixel, id
    + w0) started from the camera through the jitter ``u_pix``.  Returns
    the output state's fields and ``survive``."""
    act = state["active"]
    missed, light, surface = nqr.hit_masks(act, t, tri, n_surfaces)
    mrow = mrow.to(ft)
    normal, diffuse, emission = mrow[:, 0:3], mrow[:, 3:6], mrow[:, 6:9]
    tp, srad = state["tp"].to(ft), state["sample_rad"].to(ft)
    srad = (srad + torch.where(missed[:, None], tp * fr.env, 0.0)
            + torch.where(light[:, None], tp * emission, 0.0))
    new_d = new_d.to(ft)
    cos = (normal * new_d).sum(dim=-1)
    exhausted = surface & (state["bounce"] + 1 >= fr.max_bounces)
    survive = surface & ~exhausted
    tp = torch.where(survive[:, None],
                     tp * (diffuse / math.pi)
                     * (cos / torch.clamp(pdf.to(ft), min=1e-12))[:, None],
                     tp)
    o, d = state["o"].to(ft), state["d"].to(ft)
    hit_pos = o + t.to(ft)[:, None] * d
    o = torch.where(survive[:, None], hit_pos + fr.eps * new_d, o)
    d = torch.where(survive[:, None], new_d, d)
    bounce = torch.where(survive, state["bounce"] + 1, state["bounce"])
    finished = act & ~survive
    slot = state["slot_rad"].to(ft).clone()
    banked = torch.where(finished[:, None], srad, 0.0)
    for k in range(pix_mux):
        slot[:, k] += torch.where((state["kmx"] == k)[:, None], banked, 0.0)
    pixel, kmx, rem = state["pixel"], state["kmx"], state["remaining"]
    nxt = pixel + w0
    step_k = (finished & (rem <= 0) & (kmx + 1 < pix_mux)
              & (nxt < fr.n_pix))
    pixel = torch.where(step_k, nxt, pixel)
    kmx = torch.where(step_k, kmx + 1, kmx)
    rem = torch.where(step_k, fr.spp, rem)
    regen = finished & (rem > 0)
    u_pix = u_pix.to(ft)
    cx, cy, cz = pt.primary(pixel, u_pix[:, 0], u_pix[:, 1], cam, fr, ft)
    cam_o = torch.tensor(cam[:3], dtype=ft, device=t.device)
    lum = mrow[:, 10]
    return {"o": torch.where(regen[:, None], cam_o, o),
            "d": torch.where(regen[:, None],
                             torch.stack([cx, cy, cz], dim=-1), d),
            "tp": torch.where(regen[:, None], 1.0, tp),
            "pixel": pixel, "kmx": kmx,
            "bounce": torch.where(regen, 0, bounce),
            "remaining": torch.where(regen, rem - 1, rem),
            "active": survive | regen,
            "sample_rad": torch.where(regen[:, None], 0.0, srad),
            "slot_rad": slot,
            "cur_vol": torch.where(survive, next_vol, state["cur_vol"]),
            "cur_sector": torch.where(survive, sector, -1),
            "cur_brdf": torch.where(survive, lum / math.pi,
                                    state["cur_brdf"].to(ft)),
            "survive": survive, "regen": regen}
