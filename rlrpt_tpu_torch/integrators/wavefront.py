"""Persistent-wavefront default path tracer (counterpart of
``rlrpt_tpu/integrators/wavefront.py``).

The estimator of integrators.default_tracer (ref: default_path_tracing.cu:
36-88) as a wavefront of one ray slot per pixel:

* a slot re-traces its pixel's next sample the moment the previous one
  ends (sample regeneration), so lanes stay busy instead of waiting out
  the longest path of every spp round;
* no compaction: each bounce's closest-hit launch traces only up to the
  last live slot, a high-water mark ``m`` that stays on the device (the
  kernel reads it as ``active_count``);
* radiance accumulates per slot, and slot i is pixel i, so the frame is a
  reshape.

Randomness comes from one ``torch.Generator`` drawn per iteration for the
whole wavefront (the JAX path draws from threefry), so the image matches
the JAX one in distribution, not per pixel.  The loop asks the device
whether any slot is still active once every ``SYNC_EVERY`` bounces; an
iteration with no active slot changes nothing and is not counted in
``wavefront_iterations``.
"""

from __future__ import annotations

import math

import torch

from rlrpt_tpu_torch.camera import Camera, rotate_dirs
from rlrpt_tpu_torch.config import RHO, RenderConfig
from rlrpt_tpu_torch.ops.hemisphere import sample_uniform_direction
from rlrpt_tpu_torch.ops.intersect_pallas import (closest_hit_mat_mxu,
                                                  closest_hit_packed,
                                                  pack_scene_mxu)
from rlrpt_tpu_torch.scene.scene import Scene

INF_CUT = 1.0e38
SYNC_EVERY = 8


def _primary_dirs(generator, pixel, camera: Camera, cfg: RenderConfig):
    """Jittered primary ray directions for pixel ids (ref: ray.cu:
    145-159)."""
    px = (pixel % cfg.width).float()
    py = torch.div(pixel, cfg.width, rounding_mode="floor").float()
    u = torch.rand(pixel.shape + (2,), generator=generator,
                   device=pixel.device)
    d = torch.stack([px + u[..., 0] - cfg.width / 2.0,
                     py + u[..., 1] - cfg.height / 2.0,
                     torch.full_like(px, cfg.focal)], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return rotate_dirs(d, camera)


def render_wavefront(generator_or_seed, scene: Scene, camera: Camera,
                     cfg: RenderConfig, device, hit_mode: str = "mxu"):
    """Render a frame; returns (image (H, W, 3), aux) — statistically
    identical to render_default at the same sample budget.

    ``generator_or_seed``: a torch.Generator on ``device``, or an int seed
    for one.  ``hit_mode`` "mxu" traces with closest_hit_mat_mxu (kernel
    B4a, material rows from the kernel), "f32" with closest_hit_packed
    (kernel B4b, material by gathers); both hits are exact f32, so for one
    generator state the two images are the same.
    """
    device = torch.device(device)
    if hit_mode not in ("mxu", "f32"):
        raise ValueError(f"hit_mode must be 'mxu' or 'f32', got {hit_mode!r}")
    gen = generator_or_seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(gen))
    scene = scene.to(device)
    tris, mat = pack_scene_mxu(scene)
    ns = scene.n_surfaces
    w = cfg.n_pixels
    spp = cfg.samples_per_pixel
    f32 = dict(dtype=torch.float32, device=device)

    pixel = torch.arange(w, device=device)
    lane = torch.arange(1, w + 1, dtype=torch.int32, device=device)
    cam_o = torch.tensor(camera.position, **f32)
    d = _primary_dirs(gen, pixel, camera, cfg)
    o = cam_o.expand(w, 3).clone()
    tp = torch.ones((w, 3), **f32)
    bounce = torch.zeros((w,), dtype=torch.int32, device=device)
    remaining = torch.full((w,), spp - 1, dtype=torch.int32, device=device)
    active = torch.ones((w,), dtype=torch.bool, device=device)
    slot_rad = torch.zeros((w, 3), **f32)
    path_sum = torch.zeros((), dtype=torch.float64, device=device)
    live_iters = torch.zeros((), dtype=torch.int64, device=device)
    iters = 0

    while True:
        if iters % SYNC_EVERY == 0 and not bool(active.any()):
            break
        act = active
        live_iters = live_iters + act.any()
        # last live lane + 1 (0 when none is live), on the device
        m = torch.max(torch.where(act, lane, 0)).reshape(1)

        if hit_mode == "mxu":
            t, tri, mrow = closest_hit_mat_mxu(o, d, tris, mat, m)
            normal, diffuse = mrow[:, 0:3], mrow[:, 3:6]
            emission = mrow[:, 6:9]
        else:
            t, tri = closest_hit_packed(o, d, tris, m)
            tri = tri.long()
            normal, diffuse = scene.normal[tri], scene.diffuse_c[tri]
            emission = scene.emission[tri]
        missed = act & (t >= INF_CUT)
        hit_light = act & ~missed & (tri >= ns)
        hit_surface = act & ~missed & (tri < ns)

        slot_rad = (slot_rad
                    + torch.where(missed[:, None],
                                  tp * cfg.environment_light, 0.0)
                    + torch.where(hit_light[:, None], tp * emission, 0.0))

        exhausted = hit_surface & (bounce + 1 >= cfg.max_ray_bounces)
        survive = hit_surface & ~exhausted
        new_d, cos_theta = sample_uniform_direction(gen, normal)
        brdf = diffuse / math.pi
        pos = o + t[:, None] * d
        tp = torch.where(survive[:, None],
                         tp * brdf * (cos_theta[:, None] / RHO), tp)

        # Optional unbiased Russian roulette: kill deep low-throughput
        # survivors, reweight the ones that go on.
        rr_killed = torch.zeros_like(survive)
        if cfg.russian_roulette:
            p = torch.clamp(tp.max(dim=-1).values, cfg.rr_min_prob, 1.0)
            do_rr = survive & (bounce + 1 >= cfg.rr_start_bounce)
            u = torch.rand((w,), generator=gen, device=device)
            rr_killed = do_rr & (u >= p)
            tp = torch.where((do_rr & ~rr_killed)[:, None], tp / p[:, None],
                             tp)
            survive = survive & ~rr_killed

        o = torch.where(survive[:, None], pos + cfg.eps * new_d, o)
        d = torch.where(survive[:, None], new_d, d)
        bounce = torch.where(survive, bounce + 1, bounce)

        done = missed | hit_light | rr_killed
        fin = (bounce + 1).double()
        path_sum = (path_sum + torch.where(done, fin, 0.0).sum()
                    + torch.where(exhausted, float(cfg.max_ray_bounces),
                                  0.0).double().sum())

        # regeneration: the next sample of the same pixel
        regen = act & ~survive & (remaining > 0)
        rd = _primary_dirs(gen, pixel, camera, cfg)
        o = torch.where(regen[:, None], cam_o, o)
        d = torch.where(regen[:, None], rd, d)
        tp = torch.where(regen[:, None], 1.0, tp)
        bounce = torch.where(regen, 0, bounce)
        remaining = torch.where(regen, remaining - 1, remaining)
        active = survive | regen
        iters += 1

    img = (slot_rad / spp).reshape(cfg.height, cfg.width, 3)
    aux = {"avg_path_length": path_sum / (w * spp),
           "wavefront_iterations": live_iters}
    return img, aux
