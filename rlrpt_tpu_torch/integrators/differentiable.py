"""Differentiable rendering path: end-to-end pixel gradients (counterpart
of ``rlrpt_tpu/integrators/differentiable.py``).

The production tracers stop early once every path has ended; this variant
runs the same estimator over a fixed loop of ``max_ray_bounces`` steps
under torch autograd, so gradients flow from the pixels back to the
scene's reflectance ``diffuse_c`` and ``emission`` through the gathers.
The environment light is a config constant (``cfg.environment_light``), so
no gradient reaches it, in either package.

Discrete quantities are detached, as in the JAX package (SURVEY §7): hit
indices, hit positions, normals and sampled directions carry no gradient,
so gradients are exact for shading and material parameters at fixed path
geometry.  The gathers are ``index_select``s, whose backward is an
index_add; advanced indexing's backward, a sorted index_put, is far
slower on the card when hundreds of thousands of rays hit a few dozen
triangles.

The drawing is split from the tracing: ``render_diff`` draws each
sample's (H, W, 2) jitter and each bounce's (R, 2) uniforms from its
generator, and ``trace_sample_diff`` takes them, so a test can feed in
the JAX package's own draws.  On the card the hits go through kernel B4b
(``closest_hit_pallas``) over one BVH built per ``render_diff`` call; on
the CPU through its plain twin.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rlrpt_tpu_torch.camera import Camera, pixel_rays
from rlrpt_tpu_torch.config import RHO, RenderConfig
from rlrpt_tpu_torch.ops.bvh import Bvh, build_bvh
from rlrpt_tpu_torch.ops.hemisphere import uniform_direction_u
from rlrpt_tpu_torch.ops.intersect_pallas import (closest_hit_pallas,
                                                  pack_triangles)
from rlrpt_tpu_torch.scene.scene import AREA_LIGHT, NOTHING, SURFACE, Scene


def trace_sample_diff(o: torch.Tensor, d: torch.Tensor, scene: Scene,
                      cfg: RenderConfig, uniforms: torch.Tensor,
                      tris: torch.Tensor | None = None,
                      bvh: Bvh | None = None) -> torch.Tensor:
    """One differentiable sample per ray o, d (R, 3); returns radiance
    (R, 3).  ``uniforms``: (max_ray_bounces, R, 2), bounce b's direction
    draws.  ``tris``: pack_triangles(scene) and ``bvh``: build_bvh(tris),
    made once by the caller (else here)."""
    n, dev = o.shape[0], o.device
    if uniforms.shape != (cfg.max_ray_bounces, n, 2):
        raise ValueError(f"uniforms must be ({cfg.max_ray_bounces}, {n}, 2), "
                         f"got {tuple(uniforms.shape)}")
    if tris is None:
        tris = pack_triangles(scene)
    o, d = o.detach().contiguous(), d.detach().contiguous()
    tp = torch.ones((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for bounce in range(cfg.max_ray_bounces):
        hit = closest_hit_pallas(o, d, scene, tris=tris, bvh=bvh)
        tri = hit.tri
        is_nothing = active & (hit.hit_type == NOTHING)
        is_light = active & (hit.hit_type == AREA_LIGHT)
        is_surface = active & (hit.hit_type == SURFACE)

        radiance = (radiance
                    + (torch.where(is_nothing[:, None],
                                   tp * cfg.environment_light, 0.0)
                       + torch.where(is_light[:, None],
                                     tp * scene.emission.index_select(0, tri),
                                     0.0)))

        new_d, cos_theta = uniform_direction_u(uniforms[bounce],
                                               hit.normal.detach())
        new_d, cos_theta = new_d.detach(), cos_theta.detach()
        brdf = scene.diffuse_c.index_select(0, tri) / math.pi
        tp = torch.where(is_surface[:, None],
                         tp * brdf * (cos_theta[:, None] / RHO), tp)
        o = torch.where(is_surface[:, None],
                        hit.position.detach() + cfg.eps * new_d,
                        o).contiguous()
        d = torch.where(is_surface[:, None], new_d, d).contiguous()
        active = active & is_surface
    return radiance


def render_diff(generator_or_seed, scene: Scene, camera: Camera,
                cfg: RenderConfig, device="cuda") -> torch.Tensor:
    """Differentiable frame render on ``device``; returns the image
    (H, W, 3).  Gradients of any scalar of it reach the tensors of
    ``scene.diffuse_c`` and ``scene.emission`` that require them.

    ``generator_or_seed``: a torch.Generator on ``device``, or an int seed
    for one.  Sample k draws its (H, W, 2) jitter, then its
    (max_ray_bounces, H*W, 2) direction uniforms."""
    device = torch.device(device)
    gen = generator_or_seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(gen))
    scene = scene.to(device)
    tris = pack_triangles(scene)
    bvh = build_bvh(tris) if device.type == "cuda" else None
    n = cfg.n_pixels
    acc = torch.zeros((n, 3), dtype=torch.float32, device=device)
    for _ in range(cfg.samples_per_pixel):
        jitter = torch.rand((cfg.height, cfg.width, 2), generator=gen,
                            device=device)
        u = torch.rand((cfg.max_ray_bounces, n, 2), generator=gen,
                       device=device)
        o, d = pixel_rays(jitter, camera, cfg.width, cfg.height, cfg.focal)
        acc = acc + trace_sample_diff(o, d, scene, cfg, u, tris, bvh)
    return (acc / cfg.samples_per_pixel).reshape(cfg.height, cfg.width, 3)


def pixel_gradients(generator_or_seed, scene: Scene, camera: Camera,
                    cfg: RenderConfig, loss_fn, device="cuda"):
    """Gradients of ``loss_fn(image)`` w.r.t. the scene's continuous
    parameters.  Returns (loss, grads): grads is a Scene of tensors on
    ``device`` holding d loss / d diffuse_c and d loss / d emission, and
    zeros in the geometry fields (v0, v1, v2, normal) and luminance, which
    the renderer does not differentiate."""
    device = torch.device(device)
    scene = scene.to(device)
    diffuse_c = scene.diffuse_c.detach().clone().requires_grad_(True)
    emission = scene.emission.detach().clone().requires_grad_(True)
    live = dataclasses.replace(scene, diffuse_c=diffuse_c, emission=emission)
    loss = loss_fn(render_diff(generator_or_seed, live, camera, cfg, device))
    g_c, g_e = torch.autograd.grad(loss, (diffuse_c, emission),
                                   allow_unused=True)
    zero = torch.zeros_like
    grads = dataclasses.replace(
        scene, v0=zero(scene.v0), v1=zero(scene.v1), v2=zero(scene.v2),
        normal=zero(scene.normal), luminance=zero(scene.luminance),
        diffuse_c=zero(diffuse_c) if g_c is None else g_c,
        emission=zero(emission) if g_e is None else g_e)
    return loss.detach(), grads
