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
    # A finished sample whose mean RGB is below this counts as a
    # zero-contribution light path (ref: monte_carlo_settings.h:11).
    throughput_threshold: float = 1e-4
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
    """Tabular RL (expected SARSA) settings (ref:
    radiance_volumes_settings.h:9-23): a 12x12 hemisphere grid, one
    radiance volume per 0.001 of surface area, INITIAL_RADIANCE = 100/144,
    RADIANCE_THRESHOLD = 0.8/144.  ``defensive_mix`` blends a uniform pmf
    into the rebuilt CDF (0 == the reference's pure Q*cos CDF)."""

    grid_resolution: int = 12
    area_per_sample: float = 0.001
    distribution_threshold: float = 0.0
    defensive_mix: float = 0.0

    @property
    def n_sectors(self) -> int:
        return self.grid_resolution * self.grid_resolution

    @property
    def grid_rho(self) -> float:
        # ref: radiance_volumes_settings.h:11 `GRID_RHO = 1/144`
        return 1.0 / float(self.n_sectors)

    @property
    def initial_radiance(self) -> float:
        return (1.0 / float(self.n_sectors)) * 100.0

    @property
    def radiance_threshold(self) -> float:
        return (1.0 / float(self.n_sectors)) * 0.8


@dataclasses.dataclass(frozen=True)
class DeepLearningConfig:
    """Neural-Q settings (ref: deep_learning_settings.h:5-20, main.cu:
    116-124, dq_network.cu:14-17): epsilon-greedy start/min/decay, the
    4096-ray training batch, hidden layers 200/300/200 with ReLU on every
    layer, DyNet's Adam defaults, and the x200 light reward (ref:
    neural_q_pathtracer.cu:697)."""

    epsilon_start: float = 0.05
    epsilon_min: float = 0.05
    epsilon_decay: float = 0.01
    train_on_position: bool = False
    batch_size: int = 4096
    hidden_sizes: tuple = (200, 300, 200)
    learning_rate: float = 0.001
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    light_reward_scale: float = 200.0


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Offline distillation settings (ref: NN_Q_Value_Trainer/Source/
    settings.cuh:4-5, main.cu:140-157): batch 128, 100 epochs, an 80/20
    train/test split."""

    batch_size: int = 128
    epochs: int = 100
    train_fraction: float = 0.8
    learning_rate: float = 0.001


@dataclasses.dataclass(frozen=True)
class Config:
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    rl: RadianceVolumeConfig = dataclasses.field(
        default_factory=RadianceVolumeConfig)
    deep: DeepLearningConfig = dataclasses.field(
        default_factory=DeepLearningConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)


def small(width: int = 128, height: int = 128, spp: int = 4,
          bounces: int = 8) -> Config:
    """A small config for tests and CPU runs."""
    return Config(render=RenderConfig(width=width, height=height,
                                      samples_per_pixel=spp,
                                      max_ray_bounces=bounces,
                                      ray_tile=4096))
