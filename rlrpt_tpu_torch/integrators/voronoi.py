"""Voronoi debug renderer: primary rays coloured by their nearest radiance
volume (counterpart of ``rlrpt_tpu/integrators/voronoi.py``; ref:
voronoi_trace.cu:16-38, radiance_map.cu:205-225, colours as in
radiance_volume.cu:309-328 but kept in their own array).
"""

from __future__ import annotations

import torch

from rlrpt_tpu_torch.camera import Camera, primary_rays
from rlrpt_tpu_torch.config import RenderConfig
from rlrpt_tpu_torch.ops.intersect_pallas import closest_hit_pallas
from rlrpt_tpu_torch.radiance.nn_search import find_closest_volume
from rlrpt_tpu_torch.radiance.volumes import RadianceVolumes
from rlrpt_tpu_torch.scene.scene import SURFACE, Scene


def voronoi_colours(generator: torch.Generator,
                    n_volumes: int) -> torch.Tensor:
    """A random RGB per volume (ref: radiance_volume.cu:311-318)."""
    return torch.rand((n_volumes, 3), generator=generator,
                      device=generator.device)


def voronoi_ids(o: torch.Tensor, d: torch.Tensor, scene: Scene,
                vols: RadianceVolumes):
    """(nearest volume (R,) int64, surface-hit mask (R,)) of rays o, d;
    the hit is closest_hit_pallas (kernel B4b on the card, which builds
    the BVH for this one trace)."""
    hit = closest_hit_pallas(o.contiguous(), d.contiguous(), scene)
    return (find_closest_volume(vols, hit.position, hit.normal),
            hit.hit_type == SURFACE)


def render_voronoi(generator: torch.Generator, scene: Scene, camera: Camera,
                   vols: RadianceVolumes, colours: torch.Tensor,
                   cfg: RenderConfig) -> torch.Tensor:
    """One primary-ray pass: surface hits take the nearest volume's
    colour, everything else is white (ref: voronoi_trace.cu:30-38)."""
    o, d = primary_rays(generator, camera, cfg.width, cfg.height, cfg.focal)
    idx, surface = voronoi_ids(o, d, scene.to(o.device), vols)
    col = torch.where(surface[:, None], colours[idx], 1.0)
    return col.reshape(cfg.height, cfg.width, 3)
