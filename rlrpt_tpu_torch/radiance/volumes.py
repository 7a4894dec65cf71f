"""Radiance volumes, the tabular Q-state of the expected-SARSA tracer
(counterpart of ``rlrpt_tpu/radiance/volumes.py``).

One SoA record of (V, S) tensors: V volumes sampled over the scene's
surfaces, S = G*G hemisphere sectors each (ref: radiance_volume.cu).

* TD updates are batched scatters.  For k contributions to one entry in a
  batch, the exact sequential composition of the reference's running mean
  Q <- (1-a)Q + a*target, a = 1/(1+visits), is

      Q' = (Q*(1+visits) + sum(targets)) / (1 + visits + k)

  which ``apply_sarsa_contributions`` applies.  The scatter is
  ``index_add_`` into a (V*S+1,) buffer (masked entries park on the last
  slot).  Counts are float adds of 1.0, exact below 2^24 per entry, so the
  visit counts and the TD-visit invariant stay exact in any order of the
  card's atomics; the target sums vary in their last bits from run to run.
* The irradiance estimate is recomputed from the Q grid on demand
  (``irradiance_estimates``), not kept as an accumulator.
* cos(theta) per sector is one constant (S,) table (ops/hemisphere.py).

Every sampler has a deterministic core (``*_u``) that takes its uniforms,
and a wrapper that draws them from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rlrpt_tpu_torch.config import RHO, RadianceVolumeConfig
from rlrpt_tpu_torch.ops import hemisphere as hs
from rlrpt_tpu_torch.ops.linalg import make_frame
from rlrpt_tpu_torch.parallel.mesh import psum
from rlrpt_tpu_torch.scene.geometry import sample_points_on_triangles
from rlrpt_tpu_torch.scene.scene import Scene, surface_areas


@dataclasses.dataclass(frozen=True)
class RadianceVolumes:
    position: torch.Tensor     # (V, 3) f32
    normal: torch.Tensor       # (V, 3) f32
    frame: torch.Tensor        # (V, 3, 3) hemisphere local->world rotations
    surface_lum: torch.Tensor  # (V,) luminance of the host surface
    q: torch.Tensor            # (V, S) f32 radiance grid (the Q table)
    visits: torch.Tensor       # (V, S) int32
    cdf: torch.Tensor          # (V, S) f32 cumulative sampling distribution
    grid_resolution: int

    @property
    def n_volumes(self) -> int:
        return self.position.shape[0]

    @property
    def n_sectors(self) -> int:
        return self.grid_resolution * self.grid_resolution

    @property
    def device(self) -> torch.device:
        return self.q.device


def volume_counts(scene: Scene, cfg: RadianceVolumeConfig) -> np.ndarray:
    """Volumes per surface triangle = floor(area / AREA_PER_SAMPLE)
    (ref: radiance_map.cu:60-67)."""
    return np.floor(surface_areas(scene) / cfg.area_per_sample).astype(
        np.int64)


def build_radiance_volumes(scene: Scene, cfg: RadianceVolumeConfig,
                           seed: int = 1984, device=None) -> RadianceVolumes:
    """Uniformly sample volumes over the scene's surfaces (ref:
    radiance_map.cu:72-84) and initialise the Q state (ref:
    radiance_volume.cu:49-89) on ``device`` (default: the scene's).

    Positions come from the JAX package's host numpy draws, so the same
    seed gives the same volume set bit for bit.  The initial CDF is the
    proper uniform (i+1)/S, not the reference's ramp i/S (whose last entry
    143/144 lets its binary search fail on the first frame).
    """
    device = scene.device if device is None else torch.device(device)
    rng = np.random.default_rng(seed)
    counts = volume_counts(scene, cfg)
    ns = scene.n_surfaces
    host = lambda a: a[:ns].cpu().numpy()  # noqa: E731
    v0, v1, v2 = (host(a).astype(np.float64)
                  for a in (scene.v0, scene.v1, scene.v2))
    pos, tri_idx = sample_points_on_triangles(rng, v0, v1, v2, counts)
    normals = host(scene.normal)[tri_idx]
    lum = host(scene.luminance)[tri_idx]

    v, s = len(pos), cfg.n_sectors
    f32 = dict(dtype=torch.float32, device=device)
    normal = torch.as_tensor(normals, **f32)
    cdf0 = torch.arange(1, s + 1, **f32) / s
    return RadianceVolumes(
        position=torch.as_tensor(pos, **f32), normal=normal,
        frame=make_frame(normal), surface_lum=torch.as_tensor(lum, **f32),
        q=torch.full((v, s), cfg.initial_radiance, **f32),
        visits=torch.zeros((v, s), dtype=torch.int32, device=device),
        cdf=cdf0.expand(v, s).contiguous(),
        grid_resolution=cfg.grid_resolution)


def irradiance_estimates(vols: RadianceVolumes,
                         cos: torch.Tensor | None = None) -> torch.Tensor:
    """Per-volume irradiance estimate (V,): sum_s cos_s*(lum/pi)*Q_s
    scaled by 2*pi/S (ref: radiance_volume.cu:49-69, :305-307), exactly
    from the live Q grid.  ``cos``: sector_cos_thetas on the volumes'
    device, for a caller that asks every step."""
    if cos is None:
        cos = hs.sector_cos_thetas(vols.grid_resolution, vols.device)
    acc = torch.sum(vols.q * cos, dim=-1) * (vols.surface_lum / math.pi)
    return acc * (2.0 * math.pi / vols.n_sectors)


def rebuild_cdf(vols: RadianceVolumes, distribution_threshold: float = 0.0,
                defensive_mix: float = 0.0) -> RadianceVolumes:
    """Per-frame CDF rebuild from Q*cos weights (ref: radiance_volume.cu:
    149-188), one (V, S) cumsum.  ``defensive_mix`` > 0 blends
    mix * uniform into the normalised distribution; 0 is the reference."""
    cos = hs.sector_cos_thetas(vols.grid_resolution, vols.device)
    w = torch.clamp(vols.q * cos, min=distribution_threshold)
    total = 1e-10 + torch.sum(w, dim=-1, keepdim=True)
    p = w / total
    if defensive_mix:
        p = (1.0 - defensive_mix) * p + defensive_mix / vols.n_sectors
    return dataclasses.replace(vols, cdf=torch.cumsum(p, dim=-1))


# ---- sector samplers ------------------------------------------------------

def _pick(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return rows.gather(1, idx.long()[:, None])[:, 0]


def sample_from_cdf_rows_u(r: torch.Tensor, u: torch.Tensor,
                           rows: torch.Tensor, frames: torch.Tensor,
                           grid_rho: float, grid_resolution: int):
    """Inverse-CDF sector sampling on gathered CDF rows (N, S) for the
    uniforms r (N, 1) and the in-sector jitter u (N, 2).

    sector = #entries < r (the reference's binary search, radiance_volume.
    cu:192-244); pdf = RHO * (p_sector / GRID_RHO).  The last sector takes
    every r >= cdf[S-2], so its probability is 1 - lo: hi = 1 there keeps
    the pdf the true sampling probability for any row dtype.
    Returns (direction (N, 3), sector (N,) int64, pdf (N,)).
    """
    s = grid_resolution * grid_resolution
    sector = torch.clamp((rows < r).sum(dim=-1), max=s - 1)
    hi = torch.where(sector == s - 1, 1.0, _pick(rows, sector))
    lo = torch.where(sector > 0, _pick(rows, torch.clamp(sector - 1, min=0)),
                     0.0)
    pdf = RHO * ((hi - lo) / grid_rho)
    d = hs.sector_direction(u, sector, frames, grid_resolution)
    return d, sector, pdf


def _uniforms(generator: torch.Generator, n: int, *shapes):
    dev = generator.device
    return [torch.rand((n,) + tuple(sh), generator=generator, device=dev)
            for sh in shapes]


def sample_from_cdf_rows(generator: torch.Generator, rows: torch.Tensor,
                         frames: torch.Tensor, grid_rho: float,
                         grid_resolution: int):
    """sample_from_cdf_rows_u with uniforms from ``generator``."""
    r, u = _uniforms(generator, rows.shape[0], (1,), (2,))
    return sample_from_cdf_rows_u(r, u, rows, frames, grid_rho,
                                  grid_resolution)


def sample_from_cdf(generator: torch.Generator, vols: RadianceVolumes,
                    vol_idx: torch.Tensor, grid_rho: float):
    """Sector sampling for rays parked at volumes ``vol_idx`` (N,)
    (ref: radiance_volume.cu:192-244).  Returns (dir, sector, pdf)."""
    return sample_from_cdf_rows(generator, vols.cdf[vol_idx],
                                vols.frame[vol_idx], grid_rho,
                                vols.grid_resolution)


def sample_from_cdf_bsearch_u(r: torch.Tensor, u: torch.Tensor,
                              vols: RadianceVolumes, vol_idx: torch.Tensor,
                              grid_rho: float):
    """sample_from_cdf_rows_u by a branchless binary search over the flat
    (V*S,) CDF instead of a row gather (the reference's own search,
    radiance_volume.cu:192-217); r (N,), u (N, 2).  Same sectors as the
    row sampler for the same r."""
    s = vols.n_sectors
    flat = vols.cdf.reshape(-1)
    base = vol_idx.long() * s
    lo = torch.zeros_like(base)
    width = 1 << (s - 1).bit_length()               # next pow2 >= S
    inf = torch.tensor(float("inf"), device=flat.device)
    while width > 0:
        mid = lo + width
        val = torch.where(mid <= s, flat[base + torch.clamp(mid, max=s) - 1],
                          inf)
        lo = torch.where(val < r, torch.clamp(mid, max=s), lo)
        width >>= 1
    sector = torch.clamp(lo, max=s - 1)
    hi = torch.where(sector == s - 1, 1.0, flat[base + sector])
    prev = torch.where(sector > 0,
                       flat[base + torch.clamp(sector - 1, min=0)], 0.0)
    pdf = RHO * ((hi - prev) / grid_rho)
    d = hs.sector_direction(u, sector, vols.frame[vol_idx],
                            vols.grid_resolution)
    return d, sector, pdf


def sample_from_cdf_bsearch(generator: torch.Generator,
                            vols: RadianceVolumes, vol_idx: torch.Tensor,
                            grid_rho: float):
    """sample_from_cdf_bsearch_u with uniforms from ``generator``."""
    r, u = _uniforms(generator, vol_idx.shape[0], (), (2,))
    return sample_from_cdf_bsearch_u(r, u, vols, vol_idx, grid_rho)


def hier_cdf_tables(cdf: torch.Tensor, grid_resolution: int):
    """Split (V, S) CDFs into two-level inverse-CDF tables: (cdf_coarse
    (V, G) over the G grid rows, cdf_fine (V*G, G) within each row).
    Group-then-sector draws from exactly the flat CDF's distribution."""
    g = grid_resolution
    v = cdf.shape[0]
    grid = cdf.reshape(v, g, g)
    ends = grid[:, :, -1]                                    # (V, G)
    starts = torch.cat([torch.zeros((v, 1), dtype=cdf.dtype,
                                    device=cdf.device), ends[:, :-1]], dim=1)
    mass = torch.clamp(ends - starts, min=0.0)
    fine = (grid - starts[:, :, None]) / torch.clamp(mass, min=1e-12)[:, :,
                                                                       None]
    return ends, fine.reshape(v * g, g)


def sample_from_cdf_hier_u(u1: torch.Tensor, u2: torch.Tensor,
                           u: torch.Tensor, cdf_coarse: torch.Tensor,
                           cdf_fine: torch.Tensor, frames: torch.Tensor,
                           vol_idx: torch.Tensor, grid_rho: float,
                           grid_resolution: int):
    """Two-level sector sampling (see hier_cdf_tables) for the uniforms
    u1, u2 (N, 1) and the jitter u (N, 2)."""
    g = grid_resolution
    vol_idx = vol_idx.long()

    def level(rows, r):
        j = torch.clamp((rows < r).sum(dim=-1), max=g - 1)
        hi = torch.where(j == g - 1, 1.0, _pick(rows, j))
        lo = torch.where(j > 0, _pick(rows, torch.clamp(j - 1, min=0)), 0.0)
        return j, hi - lo

    grp, p_grp = level(cdf_coarse[vol_idx], u1)
    j, p_in = level(cdf_fine[vol_idx * g + grp], u2)
    sector = grp * g + j
    pdf = RHO * (p_grp * p_in / grid_rho)
    d = hs.sector_direction(u, sector, frames, grid_resolution)
    return d, sector, pdf


def sample_from_cdf_hier(generator: torch.Generator, cdf_coarse, cdf_fine,
                         frames, vol_idx, grid_rho: float,
                         grid_resolution: int):
    """sample_from_cdf_hier_u with uniforms from ``generator``."""
    u1, u2, u = _uniforms(generator, vol_idx.shape[0], (1,), (1,), (2,))
    return sample_from_cdf_hier_u(u1, u2, u, cdf_coarse, cdf_fine, frames,
                                  vol_idx, grid_rho, grid_resolution)


def sample_max_from_cdf_u(u: torch.Tensor, vols: RadianceVolumes,
                          vol_idx: torch.Tensor, grid_rho: float):
    """Greedy max-Q sector (ref: radiance_volume.cu:248-278) with the
    jitter u (N, 2).  A max at sector 0 reads its pdf as 0, as the
    reference does."""
    sector = torch.argmax(vols.q[vol_idx], dim=-1)
    rows = vols.cdf[vol_idx]
    hi = _pick(rows, sector)
    lo = torch.where(sector > 0, _pick(rows, torch.clamp(sector - 1, min=0)),
                     hi)
    pdf = RHO * ((hi - lo) / grid_rho)
    d = hs.sector_direction(u, sector, vols.frame[vol_idx],
                            vols.grid_resolution)
    return d, sector, pdf


def sample_max_from_cdf(generator: torch.Generator, vols: RadianceVolumes,
                        vol_idx: torch.Tensor, grid_rho: float):
    """sample_max_from_cdf_u with the jitter from ``generator``."""
    (u,) = _uniforms(generator, vol_idx.shape[0], (2,))
    return sample_max_from_cdf_u(u, vols, vol_idx, grid_rho)


# ---- TD updates -----------------------------------------------------------

def td_scratch(n_volumes: int, n_sectors: int, device):
    """The (sum_t, cnt) scatter buffers of sarsa_contributions, (V*S+1,)
    f32 each; a loop allocates them once and passes them every step."""
    n = n_volumes * n_sectors + 1
    return (torch.empty((n,), dtype=torch.float32, device=device),
            torch.empty((n,), dtype=torch.float32, device=device))


def sarsa_contributions(vol_idx: torch.Tensor, sector: torch.Tensor,
                        target: torch.Tensor, mask: torch.Tensor,
                        n_volumes: int, n_sectors: int, scratch=None):
    """Scatter per-ray TD contributions onto the (V, S) grid.  Returns
    (sum_targets (V, S), counts (V, S)), views into ``scratch`` (from
    td_scratch; zeroed here) when it is given."""
    v, s = n_volumes, n_sectors
    if scratch is None:
        scratch = td_scratch(v, s, target.device)
    sum_t, cnt = scratch
    sum_t.zero_()
    cnt.zero_()
    flat = torch.where(mask, vol_idx.long() * s + sector.long(), v * s)
    w = mask.float()
    sum_t.index_add_(0, flat, target * w)
    cnt.index_add_(0, flat, w)
    return sum_t[:-1].view(v, s), cnt[:-1].view(v, s)


def apply_sarsa_contributions(vols: RadianceVolumes, sum_t: torch.Tensor,
                              cnt: torch.Tensor,
                              radiance_threshold: float) -> RadianceVolumes:
    """Apply batched contributions with the exact sequential composition
    of the running-mean recurrence (module docstring)."""
    visits = vols.visits.float()
    q_new = (vols.q * (1.0 + visits) + sum_t) / (1.0 + visits + cnt)
    q_new = torch.clamp(q_new, min=radiance_threshold)
    q_new = torch.where(cnt > 0, q_new, vols.q)
    return dataclasses.replace(vols, q=q_new,
                               visits=vols.visits + cnt.to(torch.int32))


def expected_sarsa_update(vols: RadianceVolumes, vol_idx: torch.Tensor,
                          sector: torch.Tensor, target: torch.Tensor,
                          mask: torch.Tensor, radiance_threshold: float,
                          scratch=None, mesh=None) -> RadianceVolumes:
    """Batched expected-SARSA TD update (ref: radiance_volume.cu:283-301);
    masked-out entries are dropped.  With a ``mesh`` (parallel.mesh) the
    contributions are summed over its ranks before the apply, so every
    rank applies the same update to its replicated volumes."""
    sum_t, cnt = sarsa_contributions(vol_idx, sector, target, mask,
                                     vols.n_volumes, vols.n_sectors, scratch)
    if mesh is not None:
        sum_t, cnt = psum(torch.stack([sum_t, cnt]), mesh)
    return apply_sarsa_contributions(vols, sum_t, cnt, radiance_threshold)
