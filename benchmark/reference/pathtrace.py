"""Plain path tracing, binned expected-SARSA learning and CDF rebuild.

The arithmetic of the GPU engine's megakernels as the benchmark's
configurations state it, one torch operation at a time, vectorised over
ray slots:

* a counter hash (lowbias32) keyed on (seed, pixel, iteration, stream)
  gives every uniform, so a pixel's samples depend on nothing but its own
  slot;
* a slot owns pixels ``slot + k * n_slots`` (k < pix_mux) and runs their
  samples one after another: jittered camera ray, closest hit by exact
  Moller-Trumbore over every triangle (the first-tested triangle wins a
  tie), emission on a light, the environment on a miss, a bounce while
  the cap allows it;
* the default bounce is uniform over the hemisphere; the guided bounce
  draws a sector from the hit bin's CDF column and a point inside it
  through Chiu's concentric map;
* a learning frame applies, after every iteration, the expected-SARSA
  update of that iteration's transitions to Q over (sector, triangle x uv
  bin): Q <- max((Q (1 + V) + sum of targets) / (1 + V + count), threshold).

Every floating tensor takes the dtype ``ft``: float32 as the
configurations state, or a lower precision for the benchmark's control.
``slots`` lets a caller trace any subset of the slots: the slots never
interact in a rendering frame, so a subset's pixels are the whole frame's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

INF = 3.0e38
PI = math.pi
_M32 = 0xFFFFFFFF
HIT_PAIRS = 1 << 25    # ray-triangle pairs the closest-hit sweep holds at once


@dataclasses.dataclass(frozen=True)
class Frame:
    """What one frame renders (the configuration's and the mix's numbers)."""

    width: int
    height: int
    spp: int
    max_bounces: int
    env: float = 0.0
    eps: float = 1e-5

    @property
    def n_pix(self) -> int:
        return self.width * self.height

    @property
    def focal(self) -> float:
        return float(self.height)


def f32(x: float) -> float:
    return float(np.float32(x))


def n_slots_for(n_pix: int, r_tile: int, pix_mux: int) -> int:
    return int(math.ceil(n_pix / pix_mux / r_tile) * r_tile)


# ---- the counter hash -------------------------------------------------------

def _mul32(x, c: int):
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _hash32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform(seed: int, pix, it, stream: int, ft) -> torch.Tensor:
    """Uniforms in [0, 1): the top 24 bits of the hash times 2^-24."""
    pix = torch.as_tensor(pix, dtype=torch.int64)
    x = (int(seed) + _mul32(pix & _M32, 0x9E3779B9)
         + _mul32(torch.as_tensor(it, dtype=torch.int64) & _M32, 0x85EBCA6B)
         + ((stream * 0xC2B2AE35) & _M32)) & _M32
    return (_hash32(x) >> 8).to(ft) * (1.0 / 16777216.0)


# ---- geometry ---------------------------------------------------------------

def primary(pix, u1, u2, cam, fr: Frame, ft):
    """Jittered camera ray through pixel ``pix``; cam = (x, y, z, cos yaw_y,
    sin yaw_y, cos yaw_x, sin yaw_x)."""
    _, _, _, cy, sy, cx, sx = cam
    fpy = torch.div(pix, fr.width, rounding_mode="floor")
    fpx = (pix - fpy * fr.width).to(ft)
    fpy = fpy.to(ft)
    dx = fpx + u1 - float(fr.width / 2.0)
    dy = fpy + u2 - float(fr.height / 2.0)
    dz = torch.full_like(dx, fr.focal)
    inv = torch.rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv, dy * inv, dz * inv
    x1 = cy * dx - sy * dz
    z1 = sy * dx + cy * dz
    return x1, cx * dy + sx * z1, -sx * dy + cx * z1


def frame_tb(nx, ny, nz):
    """Tangent T and bitangent B = N x T of the shading frame."""
    zero = torch.zeros_like(nx)
    use_x = torch.abs(nx) > torch.abs(ny)
    tx = torch.where(use_x, nz, zero)
    ty = torch.where(use_x, zero, -nz)
    tz = torch.where(use_x, -nx, ny)
    tn = torch.rsqrt(torch.clamp(tx * tx + ty * ty + tz * tz, min=1e-30))
    tx, ty, tz = tx * tn, ty * tn, tz * tn
    return (tx, ty, tz), (ny * tz - nz * ty, nz * tx - nx * tz,
                          nx * ty - ny * tx)


def hemisphere_dir(u1, u2, nx, ny, nz):
    """Uniform direction about n with cos(theta) = u1."""
    sint = torch.sqrt(torch.clamp(1.0 - u1 * u1, min=0.0))
    phi = float(2.0 * PI) * u2
    lx, lz = sint * torch.cos(phi), sint * torch.sin(phi)
    (tx, ty, tz), (bx, by, bz) = frame_tb(nx, ny, nz)
    return (lx * bx + u1 * nx + lz * tx, lx * by + u1 * ny + lz * ty,
            lx * bz + u1 * nz + lz * tz)


def concentric_dir(gx, gy, nx, ny, nz):
    """Chiu's concentric map of (gx, gy) in the unit square onto the
    hemisphere about n; returns (dx, dy, dz, cos theta)."""
    w = torch.where

    def c(v):
        return torch.full_like(gx, v)

    a = 2.0 * gx - 1.0
    b = 2.0 * gy - 1.0
    abv, blw, pos_b, pos_a = b > -a, b < a, b > 0.0, a > 0.0
    xx = w(abv, w(blw, a, b), w(b > a, -a, -b))
    yy = w(abv,
           w(blw, w(pos_b, b, a + b), w(pos_a, b - a, -a)),
           w(b > a, w(pos_b, -a - b, -b), w(pos_a, a, a - b)))
    offset = w(abv,
               w(blw, w(pos_b, c(0.0), c(7.0 * PI / 4.0)),
                 w(pos_a, c(PI / 4.0), c(PI / 2.0))),
               w(b > a, w(pos_b, c(3.0 * PI / 4.0), c(PI)),
                 w(pos_a, c(3.0 * PI / 2.0), c(5.0 * PI / 4.0))))
    origin = xx == 0.0
    safe_xx = w(origin, c(1.0), xx)
    cos_t = 1.0 - xx * xx
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = offset + float(PI / 4.0) * (yy / safe_xx)
    lx = w(origin, c(0.0), sin_t * torch.cos(phi))
    lz = w(origin, c(0.0), sin_t * torch.sin(phi))
    ly = w(origin, c(1.0), cos_t)
    (tx, ty, tz), (bx, by, bz) = frame_tb(nx, ny, nz)
    return (lx * tx + ly * nx + lz * bx, lx * ty + ly * ny + lz * by,
            lx * tz + ly * nz + lz * bz, ly)


def _mt(ox, oy, oz, dx, dy, dz, tris):
    """Moller-Trumbore of rays (R,) against every triangle row of ``tris``
    (T, 12) = [v0, 0, e1, 0, e2, 0]: the sign tests multiplied through by
    det, t = t'/det.  Returns (t, tri, u', v', det) of the closest hit."""
    r = lambda a: a[:, None]  # noqa: E731
    col = lambda j: tris[:, j][None, :]  # noqa: E731
    ox, oy, oz, dx, dy, dz = map(r, (ox, oy, oz, dx, dy, dz))
    v0x, v0y, v0z = col(0), col(1), col(2)
    e1x, e1y, e1z = col(4), col(5), col(6)
    e2x, e2y, e2z = col(8), col(9), col(10)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    up = tx * px + ty * py + tz * pz
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vp = dx * qx + dy * qy + dz * qz
    tp = e2x * qx + e2y * qy + e2z * qz
    a, b = up * det, vp * det
    valid = (a >= 0.0) & (b >= 0.0) & (a + b <= det * det) & (tp * det > 0.0)
    tt = torch.where(valid, tp / det, torch.full_like(tp, INF))
    best_t, tri = torch.min(tt, dim=1)
    hit = best_t < INF
    pick = lambda q: torch.where(  # noqa: E731
        hit, q.gather(1, tri[:, None])[:, 0], torch.zeros_like(best_t))
    return best_t, tri, pick(up), pick(vp), pick(det)


def closest_hit(ox, oy, oz, dx, dy, dz, tris):
    """_mt in blocks of rays, HIT_PAIRS ray-triangle pairs at a time."""
    step = max(1, HIT_PAIRS // max(1, tris.shape[0]))
    n = ox.shape[0]
    if n <= step:
        return _mt(ox, oy, oz, dx, dy, dz, tris)
    parts = [_mt(ox[i:i + step], oy[i:i + step], oz[i:i + step],
                 dx[i:i + step], dy[i:i + step], dz[i:i + step], tris)
             for i in range(0, n, step)]
    return tuple(torch.cat(p) for p in zip(*parts))


def bin_column(hit, uv_bins: int) -> torch.Tensor:
    """Column tri * uv^2 + iu * uv + iv of the hit's barycentric bin."""
    _, tri, up, vp, det = hit
    dsafe = torch.where(det == 0.0, torch.ones_like(det), det)
    iu = torch.clamp((up / dsafe * uv_bins).to(torch.int64), 0, uv_bins - 1)
    iv = torch.clamp((vp / dsafe * uv_bins).to(torch.int64), 0, uv_bins - 1)
    return tri * (uv_bins * uv_bins) + iu * uv_bins + iv


# ---- the slot loop ----------------------------------------------------------

def uniform_sampler():
    def sample(pix, it1, u1, u2, hit, nx, ny, nz):
        dx, dy, dz = hemisphere_dir(u1, u2, nx, ny, nz)
        return dx, dy, dz, 2.0 * u1, None
    return sample


def cdf_sampler(seed: int, cdf_t: torch.Tensor, sector_grid: int,
                uv_bins: int, ft):
    """The guided bounce over a (C, S_pad) transposed CDF table; its info
    is (sector, column) of each draw."""
    n_sectors = sector_grid * sector_grid
    pdf_scale = f32(n_sectors / (2.0 * PI))
    inv_gdir = f32(1.0 / sector_grid)

    def sample(pix, it1, u1, u2, hit, nx, ny, nz):
        us = uniform(seed, pix, it1, 5, ft)
        column = bin_column(hit, uv_bins)
        col = cdf_t[column].to(ft)
        cnt = (col < us[:, None]).sum(dim=1)
        sector = torch.clamp(cnt, max=n_sectors - 1)
        hi = col.gather(1, sector[:, None])[:, 0]
        lo = torch.where(sector > 0,
                         col.gather(1, (sector - 1).clamp(min=0)[:, None])[:, 0],
                         0.0)
        hi = torch.where(sector == n_sectors - 1, 1.0, hi)
        pdf = torch.clamp(hi - lo, min=0.0) * pdf_scale
        pdf_safe = torch.clamp(pdf, min=1e-12)
        sxg = torch.div(sector, sector_grid, rounding_mode="floor")
        syg = sector - sxg * sector_grid
        gx = (sxg.to(ft) + u1) * inv_gdir
        gy = (syg.to(ft) + u2) * inv_gdir
        dx, dy, dz, cost = concentric_dir(gx, gy, nx, ny, nz)
        return dx, dy, dz, cost / (float(PI) * pdf_safe), (sector, column)
    return sample


def slot_loop(seed: int, cam: tuple, tris: torch.Tensor, mat: torch.Tensor,
              fr: Frame, n_slots: int, pix_mux: int, slots: torch.Tensor,
              sample, on_step=None, state: dict | None = None):
    """Run ``slots`` (global slot ids) through the regenerative bounce loop.
    ``on_step(act, m, missed, hit_light, survive, info, state)`` sees every
    iteration after the bounce cap; ``state`` holds
    per-slot tensors of its own, kept in step with the live slots.

    Returns rad (pix_mux, n, 3), path_sum (n,) and iters (n,) for the n
    slots given.  Slots that went idle are dropped from the working set
    (it costs nothing: an idle slot never acts again)."""
    dev = tris.device
    ft = tris.dtype
    n = slots.shape[0]
    state = dict(state or {})
    slot = slots.to(device=dev, dtype=torch.int64)
    live = torch.arange(n, device=dev)
    in_image = slot < fr.n_pix
    dx, dy, dz = primary(slot, uniform(seed, slot, 0, 2, ft),
                         uniform(seed, slot, 0, 3, ft), cam, fr, ft)
    full = lambda v: torch.full((n,), v, dtype=ft, device=dev)  # noqa: E731
    ox, oy, oz = full(cam[0]), full(cam[1]), full(cam[2])
    tr, tg, tb = full(1.0), full(1.0), full(1.0)
    bounce = torch.zeros_like(slot)
    remaining = torch.where(in_image, fr.spp - 1, 0)
    act = in_image.clone()
    pix = slot.clone()
    kmx = torch.zeros_like(slot)
    rad = torch.zeros((pix_mux, n, 3), dtype=ft, device=dev)
    path_sum = torch.zeros((n,), dtype=ft, device=dev)
    iters = torch.zeros((n,), dtype=torch.int32, device=dev)
    it = 0
    while True:
        n_act = int(act.sum())
        if n_act == 0:
            break
        if 2 * n_act <= act.shape[0]:
            keep = act.nonzero()[:, 0]
            (live, pix, kmx, remaining, bounce, act, ox, oy, oz, dx, dy, dz,
             tr, tg, tb) = (a[keep] for a in (
                 live, pix, kmx, remaining, bounce, act, ox, oy, oz, dx, dy,
                 dz, tr, tg, tb))
            state = {k: v[keep] for k, v in state.items()}
        it1 = it + 1
        u1, u2, u3, u4 = (uniform(seed, pix, it1, s, ft) for s in range(4))
        hit = closest_hit(ox, oy, oz, dx, dy, dz, tris)
        best_t, tri = hit[0], hit[1]
        m = mat[tri]
        missed = act & (best_t >= INF)
        hit_any = act & ~missed
        hit_light = hit_any & (m[:, 9] > 0.5)
        hit_surface = hit_any & ~hit_light

        thr = torch.stack([tr, tg, tb], dim=1)
        contrib = torch.where(
            missed[:, None], thr * fr.env,
            torch.where(hit_light[:, None], thr * m[:, 6:9], 0.0))
        rad[kmx, live] += contrib

        exhausted = hit_surface & (bounce + 1 >= fr.max_bounces)
        survive = hit_surface & ~exhausted
        sdx, sdy, sdz, scale, info = sample(pix, it1, u1, u2, hit,
                                            m[:, 0], m[:, 1], m[:, 2])
        tr = torch.where(survive, tr * m[:, 3] * scale, tr)
        tg = torch.where(survive, tg * m[:, 4] * scale, tg)
        tb = torch.where(survive, tb * m[:, 5] * scale, tb)

        if on_step is not None:
            on_step(act, m, missed, hit_light, survive, info, state)

        ox = torch.where(survive, ox + best_t * dx + fr.eps * sdx, ox)
        oy = torch.where(survive, oy + best_t * dy + fr.eps * sdy, oy)
        oz = torch.where(survive, oz + best_t * dz + fr.eps * sdz, oz)
        dx = torch.where(survive, sdx, dx)
        dy = torch.where(survive, sdy, dy)
        dz = torch.where(survive, sdz, dz)

        done = missed | hit_light
        step_len = torch.where(done, (bounce + 1).to(ft), 0.0)
        step_len = step_len + torch.where(
            exhausted, torch.full_like(step_len, fr.max_bounces), 0.0)
        path_sum[live] = path_sum[live] + step_len
        bounce = torch.where(survive, bounce + 1, bounce)

        freed = act & ~survive
        next_pix = pix + n_slots
        step_k = (freed & (remaining <= 0) & (kmx + 1 < pix_mux)
                  & (next_pix < fr.n_pix))
        pix = torch.where(step_k, next_pix, pix)
        kmx = torch.where(step_k, kmx + 1, kmx)
        remaining = torch.where(step_k, fr.spp, remaining)
        regen = freed & (remaining > 0)
        pdx, pdy, pdz = primary(pix, u3, u4, cam, fr, ft)
        ox = torch.where(regen, cam[0], ox)
        oy = torch.where(regen, cam[1], oy)
        oz = torch.where(regen, cam[2], oz)
        dx = torch.where(regen, pdx, dx)
        dy = torch.where(regen, pdy, dy)
        dz = torch.where(regen, pdz, dz)
        tr = torch.where(regen, 1.0, tr)
        tg = torch.where(regen, 1.0, tg)
        tb = torch.where(regen, 1.0, tb)
        bounce = torch.where(regen, 0, bounce)
        remaining = torch.where(regen, remaining - 1, remaining)
        new_act = survive | regen
        gone = act & ~new_act
        iters[live[gone]] = it1
        act = new_act
        it = it1
    return rad, path_sum, iters


def render(seed: int, cam: tuple, tris, mat, fr: Frame, n_slots: int,
           pix_mux: int, slots: torch.Tensor, cdf=None):
    """A default frame (cdf None) or a guided one over ``cdf``
    (sector_grid, uv_bins, (C, S_pad) table) of the given slots."""
    if cdf is None:
        sample = uniform_sampler()
    else:
        grid, uv, cdf_t = cdf
        sample = cdf_sampler(seed, cdf_t, grid, uv, tris.dtype)
    return slot_loop(seed, cam, tris, mat, fr, n_slots, pix_mux, slots,
                     sample)


# ---- the binned Q-state -----------------------------------------------------

def t_pad(n_tris: int, chunk: int = 256) -> int:
    """Triangle rows of the binned tables: a multiple of 8 up to one chunk
    of 256, whole chunks beyond."""
    t8 = max(8, int(math.ceil(n_tris / 8) * 8))
    return min(chunk, t8) if t8 <= chunk else int(
        math.ceil(n_tris / chunk) * chunk)


def concentric_local_y(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The local y (cos theta) of Chiu's map of (x, y)."""
    a = 2.0 * x - 1.0
    b = 2.0 * y - 1.0
    abv, blw = b > -a, b < a
    xx = torch.where(abv, torch.where(blw, a, b),
                     torch.where(b > a, -a, -b))
    return torch.where(xx == 0.0, torch.ones_like(xx), 1.0 - xx * xx)


def sector_cos(sector_grid: int, device, ft) -> torch.Tensor:
    """cos(theta) of each sector's centre, index sx * G + sy."""
    g = sector_grid
    ar = torch.arange(g, dtype=torch.float32, device=device)
    sx, sy = ar.repeat_interleave(g), ar.repeat(g)
    return concentric_local_y((sx + 0.5) / float(g),
                              (sy + 0.5) / float(g)).to(ft)


def init_q(n_cols: int, sector_grid: int, initial_radiance: float, device,
           ft):
    s = sector_grid * sector_grid
    s_pad = int(math.ceil(s / 8) * 8)
    q = torch.zeros((s_pad, n_cols), dtype=ft, device=device)
    q[:s] = initial_radiance
    return q, torch.zeros((s_pad, n_cols), dtype=ft, device=device)


def rebuild_cdf(q: torch.Tensor, sector_grid: int,
                distribution_threshold: float = 0.0,
                defensive_mix: float = 0.0) -> torch.Tensor:
    """(S_pad, C) bf16 table of per-column CDFs over the sectors of
    Q * cos(theta), padding rows 2.0, the last sector's entry exactly 1."""
    s = sector_grid * sector_grid
    cos = sector_cos(sector_grid, q.device, q.dtype)
    w = torch.clamp(q[:s] * cos[:, None], min=distribution_threshold)
    total = 1e-10 + torch.sum(w, dim=0)
    p = w / total[None, :]
    if defensive_mix:
        p = (1.0 - defensive_mix) * p + defensive_mix / s
    cdf = torch.cumsum(p, dim=0)
    cdf[s - 1] = 1.0
    out = torch.full((q.shape[0], q.shape[1]), 2.0, dtype=q.dtype,
                     device=q.device)
    out[:s] = cdf
    return out.to(torch.bfloat16)


def bin_luminance(luminance: torch.Tensor, n_cols: int,
                  uv_bins: int) -> torch.Tensor:
    """(C,) luminance of every bin: its triangle's, 0 on padding rows."""
    lum = torch.zeros((n_cols // (uv_bins * uv_bins),),
                      dtype=luminance.dtype, device=luminance.device)
    lum[:luminance.shape[0]] = luminance
    return lum.repeat_interleave(uv_bins * uv_bins)


def learn_frame(seed: int, cam: tuple, tris, mat, fr: Frame, n_slots: int,
                pix_mux: int, cdf: torch.Tensor, luminance: torch.Tensor,
                q: torch.Tensor, visits: torch.Tensor, sector_grid: int,
                uv_bins: int, radiance_threshold: float):
    """One learning frame over the (S_pad, C) table ``cdf``: every slot,
    one iteration at a time, the transitions of each iteration applied to
    Q before the next.  Returns (rad, path_sum, iters, q, visits, td):
    new tensors, td the count of transitions learned."""
    dev, ft = tris.device, tris.dtype
    s = sector_grid * sector_grid
    n_cols = cdf.shape[1]
    q, visits = q.to(ft).clone(), visits.to(ft).clone()
    cos = sector_cos(sector_grid, dev, ft)
    lum = bin_luminance(luminance.to(ft), n_cols, uv_bins)
    scale = f32(f32(2.0 * PI / s) / f32(PI))
    thr = f32(radiance_threshold)

    def irradiance():
        return torch.sum(q[:s] * cos[:, None], dim=0) * lum * scale

    learn = {"irr": irradiance(),
             "td": torch.zeros((), dtype=torch.float64, device=dev)}
    n = n_slots

    def on_step(act, m, missed, hit_light, survive, info, st):
        sector, col = info
        cur_sec, cur_bin, cur_brdf = st["sec"], st["bin"], st["brdf"]
        pending = act & (cur_sec >= 0)
        target = torch.where(
            missed, cur_brdf * fr.env,
            torch.where(hit_light, cur_brdf * m[:, 10],
                        cur_brdf * learn["irr"][col]))
        cell = (cur_sec * n_cols + cur_bin)[pending]
        sum_t = torch.zeros((q.numel(),), dtype=ft, device=dev)
        cnt = torch.zeros((q.numel(),), dtype=ft, device=dev)
        sum_t.index_add_(0, cell, target[pending])
        cnt.index_add_(0, cell, torch.ones_like(target[pending]))
        sum_t, cnt = sum_t.view(q.shape), cnt.view(q.shape)
        q_new = torch.clamp((q * (1.0 + visits) + sum_t)
                            / (1.0 + visits + cnt), min=thr)
        q.copy_(torch.where(cnt > 0, q_new, q))
        visits.add_(cnt)
        learn["irr"] = irradiance()
        learn["td"] += pending.sum()
        st["bin"] = torch.where(survive, col, cur_bin)
        st["sec"] = torch.where(survive, sector, -1)
        st["brdf"] = torch.where(survive, m[:, 10] / float(PI), cur_brdf)

    state = {"bin": torch.zeros((n,), dtype=torch.int64, device=dev),
             "sec": torch.full((n,), -1, dtype=torch.int64, device=dev),
             "brdf": torch.zeros((n,), dtype=ft, device=dev)}
    slots = torch.arange(n, device=dev)
    rad, path_sum, iters = slot_loop(
        seed, cam, tris, mat, fr, n_slots, pix_mux, slots,
        cdf_sampler(seed, cdf.T.contiguous(), sector_grid, uv_bins, ft),
        on_step, state)
    return rad, path_sum, iters, q, visits, learn["td"]
