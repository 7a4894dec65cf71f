"""Inference-only neural-Q path tracer, lockstep (counterpart of
``rlrpt_tpu/deep/pretrained.py``; ref: pre_trained_pathtracer.cu).

The training tracer's bounce loop with a frozen network: pure importance
sampling over Q * cos (epsilon = 0, :286), no TD updates and no
learning-only respawns, and a trace that leaves terminated rays untouched
(:413-491).  The hit is kernel B4a; the loop reads its continue flag on
the host once per bounce.
"""

from __future__ import annotations

import math

import torch

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import (DeepLearningConfig, RadianceVolumeConfig,
                                    RenderConfig)
from rlrpt_tpu_torch.deep.neural_q import (ACTIVE, _generator, _q_forward,
                                           init_rays, make_hit_fn,
                                           sample_directions)
from rlrpt_tpu_torch.nn.dq_network import DQNetwork
from rlrpt_tpu_torch.scene.scene import AREA_LIGHT, NOTHING, SURFACE, Scene


@torch.no_grad()
def _trace_sample_pretrained(generator, scene: Scene, camera: Camera,
                             net: DQNetwork, cfg: RenderConfig,
                             rl: RadianceVolumeConfig,
                             dl: DeepLearningConfig, hit_fn):
    state = init_rays(generator, camera, cfg)
    for bounce in range(cfg.max_ray_bounces):
        active = state.states == ACTIVE
        if bounce > 0:
            qs = _q_forward(net, scene, state.loc, dl)
            d, a, factor = sample_directions(generator, qs, state, 0.0,
                                             rl.grid_resolution, rl.grid_rho)
            tp = torch.where(active[:, None],
                             state.throughput * factor[:, None],
                             state.throughput)
            state = state._replace(direction=d, action=a, throughput=tp)
        hit, mat = hit_fn((state.loc + cfg.eps * state.direction)
                          .contiguous(), state.direction.contiguous())
        is_nothing = active & (hit.hit_type == NOTHING)
        is_light = active & (hit.hit_type == AREA_LIGHT)
        is_surface = active & (hit.hit_type == SURFACE)
        tp_mult = torch.where(
            is_nothing[:, None], cfg.environment_light,
            torch.where(is_light[:, None], mat[:, 6:9],
                        torch.where(is_surface[:, None],
                                    mat[:, 3:6] / math.pi, 1.0)))
        terminated = is_nothing | is_light
        state = state._replace(
            loc=torch.where(is_surface[:, None], hit.position, state.loc),
            normal=torch.where(is_surface[:, None], hit.normal,
                               state.normal),
            states=torch.where(terminated, 1, state.states),
            throughput=state.throughput * tp_mult,
            bounces=torch.where(terminated, bounce, state.bounces))
        if not bool(is_surface.any()):
            break
    return state


def render_frame_pretrained(generator_or_seed, scene: Scene, camera: Camera,
                            net: DQNetwork, cfg: RenderConfig,
                            rl: RadianceVolumeConfig,
                            dl: DeepLearningConfig):
    """Render one frame with a frozen network; returns (image (H, W, 3),
    aux with avg_path_length)."""
    device = next(net.parameters()).device
    gen = _generator(generator_or_seed, device)
    scene = scene.to(device)
    hit_fn = make_hit_fn(scene)
    n, spp = cfg.n_pixels, cfg.samples_per_pixel
    total_tp = torch.zeros((n, 3), dtype=torch.float32, device=device)
    path_acc = torch.zeros((n,), dtype=torch.int64, device=device)
    for _ in range(spp):
        state = _trace_sample_pretrained(gen, scene, camera, net, cfg, rl, dl,
                                         hit_fn)
        total_tp = total_tp + state.throughput
        path_acc = path_acc + state.bounces
    img = (total_tp / spp).reshape(cfg.height, cfg.width, 3)
    return img, {"avg_path_length": path_acc.double().mean() / spp}
