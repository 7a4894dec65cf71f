"""Default (uniform-hemisphere) Monte-Carlo path tracer, plain torch
(counterpart of ``rlrpt_tpu/integrators/default_tracer.py``).

A wavefront over every pixel: one masked bounce loop per sample, the
estimator of the reference default tracer
(ref: default_path_tracing.cu:36-88):

  hit NOTHING     -> contribute throughput * ENVIRONMENT_LIGHT
  hit AREA_LIGHT  -> contribute throughput * diffuse_p
  hit SURFACE     -> throughput *= (diffuse_c/pi) * cos_theta / RHO
  bounce cap MAX  -> contribute 0

It draws from ``torch.Generator`` streams, so it matches the megakernels
in distribution, not per pixel; it is their statistical anchor.
"""

from __future__ import annotations

import math

import torch

from rlrpt_tpu_torch.camera import Camera, primary_rays
from rlrpt_tpu_torch.config import RHO, RenderConfig
from rlrpt_tpu_torch.ops.hemisphere import sample_uniform_direction
from rlrpt_tpu_torch.ops.intersect import closest_hit
from rlrpt_tpu_torch.scene.scene import AREA_LIGHT, NOTHING, SURFACE, Scene


def trace_sample(generator: torch.Generator, o: torch.Tensor,
                 d: torch.Tensor, scene: Scene, cfg: RenderConfig):
    """Trace one sample per ray; returns (radiance (R, 3), path_len (R,))."""
    n = o.shape[0]
    dev = o.device
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    # Rays that exhaust the bounce budget report MAX_RAY_BOUNCES
    # (ref: default_path_tracing.cu:86-87).
    path_len = torch.full((n,), cfg.max_ray_bounces, dtype=torch.int64,
                          device=dev)
    for bounce in range(cfg.max_ray_bounces):
        if not bool(active.any()):
            break
        hit = closest_hit(o, d, scene, ray_tile=cfg.ray_tile)
        is_nothing = active & (hit.hit_type == NOTHING)
        is_light = active & (hit.hit_type == AREA_LIGHT)
        is_surface = active & (hit.hit_type == SURFACE)

        radiance = (radiance
                    + torch.where(is_nothing[:, None],
                                  throughput * cfg.environment_light, 0.0)
                    + torch.where(is_light[:, None],
                                  throughput * scene.emission[hit.tri], 0.0))

        new_d, cos_theta = sample_uniform_direction(generator, hit.normal)
        brdf = scene.diffuse_c[hit.tri] / math.pi
        throughput = torch.where(
            is_surface[:, None],
            throughput * brdf * (cos_theta[:, None] / RHO), throughput)
        o = torch.where(is_surface[:, None], hit.position + cfg.eps * new_d, o)
        d = torch.where(is_surface[:, None], new_d, d)

        path_len = torch.where(is_nothing | is_light,
                               torch.full_like(path_len, bounce + 1),
                               path_len)
        active = is_surface

        # Optional unbiased Russian roulette: survival weighting keeps
        # E[radiance] unchanged.
        if cfg.russian_roulette:
            p = torch.clamp(throughput.max(dim=-1).values, cfg.rr_min_prob,
                            1.0)
            do_rr = active & (bounce + 1 >= cfg.rr_start_bounce)
            u = torch.rand((n,), generator=generator, device=dev)
            killed = do_rr & (u >= p)
            throughput = torch.where((do_rr & ~killed)[:, None],
                                     throughput / p[:, None], throughput)
            path_len = torch.where(killed, torch.full_like(path_len,
                                                           bounce + 1),
                                   path_len)
            active = active & ~killed
    return radiance, path_len


def render_default(seed: int, scene: Scene, camera: Camera,
                   cfg: RenderConfig, device):
    """Render a frame; returns (image (H, W, 3), aux dict with
    avg_path_length, the reference's printed stat, main.cu:223-229)."""
    device = torch.device(device)
    scene = scene.to(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n = cfg.n_pixels
    acc = torch.zeros((n, 3), dtype=torch.float32, device=device)
    path_acc = torch.zeros((n,), dtype=torch.int64, device=device)
    for _ in range(cfg.samples_per_pixel):
        o, d = primary_rays(gen, camera, cfg.width, cfg.height, cfg.focal)
        rad, plen = trace_sample(gen, o, d, scene, cfg)
        acc += rad
        path_acc += plen
    img = (acc / cfg.samples_per_pixel).reshape(cfg.height, cfg.width, 3)
    avg_path = path_acc.double().mean() / cfg.samples_per_pixel
    return img, {"avg_path_length": float(avg_path)}
