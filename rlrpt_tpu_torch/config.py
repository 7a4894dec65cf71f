"""Runtime configuration (counterpart of ``rlrpt_tpu/config.py``).

Plain frozen dataclasses with the JAX package's field names and defaults
(only the fields the ported code reads), so a config built for one
renders the same frame in the other.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

# Probability of a direction on the unit hemisphere under a uniform pdf
# (ref: image_settings.h:12 `#define RHO (1.f / (2.f*pi))`).
RHO = 1.0 / (2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Image + Monte-Carlo settings (ref: image_settings.h:7-10,
    monte_carlo_settings.h:8-11): 720x720, focal = height, 80 bounces,
    32 spp, env light 0.  Russian roulette is optional and unbiased; it is
    off by default for reference parity."""

    width: int = 720
    height: int = 720
    focal_length: Optional[int] = None  # defaults to `height` like the ref
    samples_per_pixel: int = 32
    max_ray_bounces: int = 80
    environment_light: float = 0.0
    # Surface offset of secondary-ray origins
    # (ref: default_path_tracing.cu:79 `position + 0.00001f * dir`).
    eps: float = 1e-5
    russian_roulette: bool = False
    rr_start_bounce: int = 3
    rr_min_prob: float = 0.05
    # Ray-batch tile of the plain closest-hit sweep (ops.intersect).
    ray_tile: int = 8192

    @property
    def focal(self) -> float:
        return float(self.focal_length if self.focal_length is not None
                     else self.height)

    @property
    def n_pixels(self) -> int:
        return self.width * self.height


@dataclasses.dataclass(frozen=True)
class RadianceVolumeConfig:
    """Tabular RL (expected SARSA) settings used by the binned pipeline
    (ref: radiance_volumes_settings.h:9-23): a 12x12 hemisphere grid,
    INITIAL_RADIANCE = 100/144, RADIANCE_THRESHOLD = 0.8/144.
    ``defensive_mix`` blends a uniform pmf into the rebuilt CDF (0 == the
    reference's pure Q*cos CDF)."""

    grid_resolution: int = 12
    distribution_threshold: float = 0.0
    defensive_mix: float = 0.0

    @property
    def n_sectors(self) -> int:
        return self.grid_resolution * self.grid_resolution

    @property
    def initial_radiance(self) -> float:
        return (1.0 / float(self.n_sectors)) * 100.0

    @property
    def radiance_threshold(self) -> float:
        return (1.0 / float(self.n_sectors)) * 0.8
