"""The CPU engine's precomputed radiance maps (counterpart of
``rlrpt_tpu/integrators/precompute.py``):

* ``precompute_radiance_grids``: seed every volume's Q grid by path
  tracing jittered rays per sector (ref: Old_CPU_Rendering_Engine/.../
  radiance_volume.cpp:63-100);
* ``render_precomputed_irradiance``: a primary-hit render of the
  interpolated irradiance (ref: precompute_irradiance_path_tracing.cpp:
  20-53);
* ``render_importance_sampled``: a path trace guided by a frozen map, no
  learning (ref: importance_sampling_path_tracing.cpp:32-89), with the hit
  through closest_hit_pallas (kernel B4b on the card).

As in the JAX package the grid is the GPU engine's scalar Q, so the
precompute stores the luminance 0.5*(max+min) of the traced RGB estimate
(material.cu:4-14).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rlrpt_tpu_torch.camera import Camera, primary_rays
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.integrators.default_tracer import trace_sample
from rlrpt_tpu_torch.ops import hemisphere as hs
from rlrpt_tpu_torch.ops.bvh import build_bvh
from rlrpt_tpu_torch.ops.intersect_pallas import (closest_hit_pallas,
                                                  pack_triangles)
from rlrpt_tpu_torch.radiance.interpolation import interpolated_irradiance
from rlrpt_tpu_torch.radiance.nn_search import find_closest_volume
from rlrpt_tpu_torch.radiance.volumes import (RadianceVolumes, rebuild_cdf,
                                              sample_from_cdf)
from rlrpt_tpu_torch.scene.scene import AREA_LIGHT, NOTHING, SURFACE, Scene


def precompute_radiance_grids(generator: torch.Generator, scene: Scene,
                              vols: RadianceVolumes, cfg: RenderConfig,
                              spp: int = 16) -> RadianceVolumes:
    """Fill every volume's Q grid with the mean luminance of ``spp``
    jittered paths per sector traced from the volume (ref:
    radiance_volume.cpp:63-100); returns the volumes with the CDF
    rebuilt."""
    v, s, g = vols.n_volumes, vols.n_sectors, vols.grid_resolution
    dev = vols.device
    scene = scene.to(dev)
    sx, sy = hs.sector_index_to_grid(torch.arange(s, device=dev), g)
    total = torch.zeros((v, s), dtype=torch.float32, device=dev)
    for _ in range(spp):
        r = torch.rand((v, s, 2), generator=generator, device=dev)
        d = hs.grid_pos_to_direction(sx.float() + r[..., 0],
                                     sy.float() + r[..., 1],
                                     vols.frame[:, None, :, :], g)
        o = vols.position[:, None, :] + cfg.eps * d
        rad, _ = trace_sample(generator, o.reshape(-1, 3), d.reshape(-1, 3),
                              scene, cfg)
        lum = 0.5 * (rad.max(dim=-1).values + rad.min(dim=-1).values)
        total += lum.reshape(v, s)
    return rebuild_cdf(dataclasses.replace(vols, q=total / spp))


def render_precomputed_irradiance(generator: torch.Generator, scene: Scene,
                                  camera: Camera, vols: RadianceVolumes,
                                  cfg: RenderConfig, max_dist: float = 0.5):
    """Primary-hit render of the interpolated irradiance estimates (ref:
    precompute_irradiance_path_tracing.cpp:20-53)."""
    o, d = primary_rays(generator, camera, cfg.width, cfg.height, cfg.focal)
    scene = scene.to(o.device)
    # one trace a call: the launcher builds the BVH for it on the card
    hit = closest_hit_pallas(o.contiguous(), d, scene)
    irr = interpolated_irradiance(vols, hit.position, hit.normal,
                                  scene.diffuse_c[hit.tri], max_dist)
    col = torch.where(
        (hit.hit_type == SURFACE)[:, None], irr,
        torch.where((hit.hit_type == AREA_LIGHT)[:, None],
                    scene.emission[hit.tri], 0.0))
    return col.reshape(cfg.height, cfg.width, 3)


def render_importance_sampled(generator: torch.Generator, scene: Scene,
                              camera: Camera, vols: RadianceVolumes,
                              cfg: RenderConfig, rl: RadianceVolumeConfig):
    """Path trace guided by a frozen radiance map: importance sampling
    from its CDFs with no learning (ref: importance_sampling_path_tracing.
    cpp:32-89).  Returns (image, aux)."""
    dev = vols.device
    scene = scene.to(dev)
    tris = pack_triangles(scene)
    bvh = build_bvh(tris)   # once a frame, on the table's device
    n = cfg.n_pixels
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for _ in range(cfg.samples_per_pixel):
        o, d = (a.contiguous() for a in primary_rays(
            generator, camera, cfg.width, cfg.height, cfg.focal))
        tp = torch.ones((n, 3), dtype=torch.float32, device=dev)
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        for _ in range(cfg.max_ray_bounces):
            if not bool(active.any()):
                break
            hit = closest_hit_pallas(o, d, scene, tris, bvh=bvh)
            is_nothing = active & (hit.hit_type == NOTHING)
            is_light = active & (hit.hit_type == AREA_LIGHT)
            is_surface = active & (hit.hit_type == SURFACE)
            acc += (torch.where(is_nothing[:, None],
                                tp * cfg.environment_light, 0.0)
                    + torch.where(is_light[:, None],
                                  tp * scene.emission[hit.tri], 0.0))
            vol = find_closest_volume(vols, hit.position, hit.normal)
            new_d, _, pdf = sample_from_cdf(generator, vols, vol,
                                            rl.grid_rho)
            cos_theta = torch.sum(hit.normal * new_d, dim=-1)
            brdf = scene.diffuse_c[hit.tri] / math.pi
            tp = torch.where(is_surface[:, None],
                             tp * brdf * (cos_theta / torch.clamp(
                                 pdf, min=1e-12))[:, None], tp)
            o = torch.where(is_surface[:, None],
                            hit.position + cfg.eps * new_d, o)
            d = torch.where(is_surface[:, None], new_d, d)
            active = is_surface
    img = (acc / cfg.samples_per_pixel).reshape(cfg.height, cfg.width, 3)
    return img, {}
