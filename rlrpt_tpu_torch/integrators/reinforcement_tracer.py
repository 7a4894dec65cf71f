"""Expected-SARSA reinforcement path tracer, lockstep (counterpart of
``rlrpt_tpu/integrators/reinforcement_tracer.py``).

Per bounce, for every ray of one sample per pixel at once
(ref: reinforcement_path_tracing.cu:50-120, radiance_map.cu:91-146):

  1. TD-update the sector chosen at the previous vertex with a target from
     what this bounce hit (environment, light luminance, or the next
     volume's irradiance estimate, each times the previous surface's
     luminance/pi), one batched scatter;
  2. importance-sample the next direction from the nearest volume's CDF,
     throughput *= (diffuse_c/pi) * cos_theta / pdf;

and the CDFs are rebuilt once per frame (ref: reinforcement_path_tracing.
cu:6-13).  The hit is ``closest_hit_pallas`` (kernel B4b on the card), the
nearest volume the dense search.  The bounce loop reads the live flag on
the host every bounce (the flag OR'd over the ranks under a mesh).
"""

from __future__ import annotations

import math

import torch

from rlrpt_tpu_torch.camera import Camera, primary_rays
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.ops.bvh import Bvh, build_bvh
from rlrpt_tpu_torch.ops.intersect_pallas import (closest_hit_pallas,
                                                  pack_triangles)
from rlrpt_tpu_torch.parallel.mesh import any_rank, psum
from rlrpt_tpu_torch.radiance.nn_search import find_closest_volume
from rlrpt_tpu_torch.radiance.volumes import (RadianceVolumes,
                                              expected_sarsa_update,
                                              irradiance_estimates,
                                              rebuild_cdf, sample_from_cdf,
                                              td_scratch)
from rlrpt_tpu_torch.scene.scene import AREA_LIGHT, NOTHING, SURFACE, Scene


def trace_sample_sarsa(generator: torch.Generator, o: torch.Tensor,
                       d: torch.Tensor, scene: Scene, vols: RadianceVolumes,
                       cfg: RenderConfig, rl: RadianceVolumeConfig,
                       tris: torch.Tensor | None = None, scratch=None,
                       bvh: Bvh | None = None, mesh=None):
    """One sample per ray with online SARSA learning.  Returns (radiance
    (R, 3), path_len (R,), updated volumes, TD scatters issued (device
    int64: the visit-count delta)).  ``tris``: pack_triangles(scene) and
    ``bvh``: build_bvh(tris), made here if not given; ``scratch``:
    volumes.td_scratch buffers, allocated here if not given.

    With a ``mesh`` (parallel.mesh) each rank holds a shard of the rays
    and a replica of the volumes: every bounce's TD contributions are
    summed over the ranks before the update, the bounce loop ends when no
    rank has a live ray, and the TD scatter count is the ranks' sum."""
    dev = o.device
    n = o.shape[0]
    o, d = o.contiguous(), d.contiguous()
    if tris is None:
        tris = pack_triangles(scene)
    if bvh is None:
        bvh = build_bvh(tris)
    if scratch is None:
        scratch = td_scratch(vols.n_volumes, vols.n_sectors, dev)
    tp = torch.ones((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    path_len = torch.full((n,), cfg.max_ray_bounces, dtype=torch.int64,
                          device=dev)
    cur_vol = torch.zeros((n,), dtype=torch.int64, device=dev)
    cur_sector = torch.full((n,), -1, dtype=torch.int64, device=dev)
    cur_brdf = torch.zeros((n,), dtype=torch.float32, device=dev)
    td_count = torch.zeros((), dtype=torch.int64, device=dev)
    for bounce in range(cfg.max_ray_bounces):
        if not any_rank(active.any(), mesh):
            break
        hit = closest_hit_pallas(o, d, scene, tris, bvh=bvh)
        is_nothing = active & (hit.hit_type == NOTHING)
        is_light = active & (hit.hit_type == AREA_LIGHT)
        is_surface = active & (hit.hit_type == SURFACE)
        lum = scene.luminance[hit.tri]
        next_vol = find_closest_volume(vols, hit.position, hit.normal)

        # 1. TD update of the previously chosen sector
        pending = active & (cur_sector >= 0)
        irr = irradiance_estimates(vols)
        target = torch.where(
            hit.hit_type == NOTHING, cur_brdf * cfg.environment_light,
            torch.where(hit.hit_type == AREA_LIGHT, cur_brdf * lum,
                        cur_brdf * irr[next_vol]))
        td_count = td_count + pending.sum()
        vols = expected_sarsa_update(vols, cur_vol,
                                     torch.clamp(cur_sector, min=0), target,
                                     pending, rl.radiance_threshold, scratch,
                                     mesh)

        # 2. terminal contributions
        radiance = (radiance
                    + torch.where(is_nothing[:, None],
                                  tp * cfg.environment_light, 0.0)
                    + torch.where(is_light[:, None],
                                  tp * scene.emission[hit.tri], 0.0))

        # 3. importance-sample the next direction
        new_d, sector, pdf = sample_from_cdf(generator, vols, next_vol,
                                             rl.grid_rho)
        cos_theta = torch.sum(hit.normal * new_d, dim=-1)
        brdf = scene.diffuse_c[hit.tri] / math.pi
        tp = torch.where(is_surface[:, None],
                         tp * brdf * (cos_theta
                                      / torch.clamp(pdf, min=1e-12))[:, None],
                         tp)
        o = torch.where(is_surface[:, None], hit.position + cfg.eps * new_d,
                        o)
        d = torch.where(is_surface[:, None], new_d, d)
        path_len = torch.where(is_nothing | is_light, bounce + 1, path_len)
        active = is_surface

        # optional unbiased Russian roulette
        if cfg.russian_roulette:
            p = torch.clamp(tp.max(dim=-1).values, cfg.rr_min_prob, 1.0)
            do_rr = active & (bounce + 1 >= cfg.rr_start_bounce)
            u = torch.rand((n,), generator=generator, device=dev)
            killed = do_rr & (u >= p)
            tp = torch.where((do_rr & ~killed)[:, None], tp / p[:, None], tp)
            path_len = torch.where(killed, bounce + 1, path_len)
            active = active & ~killed

        # pending TD state for the next bounce (ref: reinforcement_path_
        # tracing.cu:104-110)
        cur_vol = torch.where(is_surface, next_vol, cur_vol)
        cur_sector = torch.where(is_surface, sector, -1)
        cur_brdf = torch.where(is_surface, lum / math.pi, cur_brdf)
    if mesh is not None:
        td_count = psum(td_count.reshape(1), mesh)[0]
    return radiance, path_len, vols, td_count


def render_frame_sarsa(generator_or_seed, scene: Scene, camera: Camera,
                       vols: RadianceVolumes, cfg: RenderConfig,
                       rl: RadianceVolumeConfig):
    """Render one frame while learning; returns (image, volumes, aux) with
    the reference's per-frame stats (main.cu:322-339): avg_path_length and
    zero_contribution_light_paths (samples whose mean RGB is below
    THROUGHPUT_THRESHOLD), plus td_scatter_count.  The CDF is rebuilt at
    the end of the frame (ref: main.cu:342-344)."""
    device = vols.device
    gen = generator_or_seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(gen))
    scene = scene.to(device)
    tris = pack_triangles(scene)
    bvh = build_bvh(tris)   # once a frame, on the table's device
    scratch = td_scratch(vols.n_volumes, vols.n_sectors, device)
    n = cfg.n_pixels
    acc = torch.zeros((n, 3), dtype=torch.float32, device=device)
    path_acc = torch.zeros((n,), dtype=torch.int64, device=device)
    zclp = torch.zeros((), dtype=torch.int64, device=device)
    td = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(cfg.samples_per_pixel):
        o, d = primary_rays(gen, camera, cfg.width, cfg.height, cfg.focal)
        rad, plen, vols, td_s = trace_sample_sarsa(gen, o, d, scene, vols,
                                                   cfg, rl, tris, scratch,
                                                   bvh)
        acc += rad
        path_acc += plen
        zclp = zclp + (rad.mean(-1) < cfg.throughput_threshold).sum()
        td = td + td_s
    vols = rebuild_cdf(vols, rl.distribution_threshold, rl.defensive_mix)
    img = (acc / cfg.samples_per_pixel).reshape(cfg.height, cfg.width, 3)
    aux = {"avg_path_length": path_acc.double().mean()
           / cfg.samples_per_pixel,
           "zero_contribution_light_paths": zclp,
           "td_scatter_count": td}
    return img, vols, aux
