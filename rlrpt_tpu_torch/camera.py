"""Pinhole camera with a yaw pair (counterpart of ``rlrpt_tpu/camera.py``).

Primary rays match Ray::sample_ray_through_pixel + rotate_ray
(ref: ray.cu:145-172): dir = (x - W/2, y - H/2, focal) normalised, then
rotated by R_y(yaw_y) and R_x(yaw_x).

The camera is a few host floats (float32 values, as the JAX camera holds
them): the kernels take them as launch parameters, so rendering a frame
never waits on the device to read the camera.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    position: tuple   # (x, y, z), float32 values
    yaw_y: float      # float32 value
    yaw_x: float      # float32 value

    @staticmethod
    def create(position, yaw_y: float = 0.0, yaw_x: float = 0.0) -> "Camera":
        f32 = lambda v: float(np.float32(v))  # noqa: E731
        return Camera(position=tuple(f32(v) for v in np.ravel(position)),
                      yaw_y=f32(yaw_y), yaw_x=f32(yaw_x))

    def yaw_cos_sin(self) -> tuple:
        """(cos yaw_y, sin yaw_y, cos yaw_x, sin yaw_x) computed in float32
        as the JAX camera computes them."""
        y = torch.tensor(self.yaw_y, dtype=torch.float32)
        x = torch.tensor(self.yaw_x, dtype=torch.float32)
        return tuple(float(v) for v in (torch.cos(y), torch.sin(y),
                                        torch.cos(x), torch.sin(x)))


def rotate_dirs(d: torch.Tensor, camera: Camera) -> torch.Tensor:
    """Apply Ray::rotate_ray (ref: ray.cu:163-172) to directions (..., 3)."""
    cy, sy, cx, sx = camera.yaw_cos_sin()
    x1 = cy * d[..., 0] - sy * d[..., 2]
    y1 = d[..., 1]
    z1 = sy * d[..., 0] + cy * d[..., 2]
    y2 = cx * y1 + sx * z1
    z2 = -sx * y1 + cx * z1
    return torch.stack([x1, y2, z2], dim=-1)


def pixel_rays(jitter: torch.Tensor, camera: Camera, width: int, height: int,
               focal: float):
    """Rays through every pixel for a given (H, W, 2) sub-pixel jitter, on
    the jitter's device.

    Returns (origins (H*W, 3), dirs (H*W, 3)) row-major by (y, x): image
    [y, x] is ray y*width + x.  ref: ray.cu:145-159.
    """
    dev = jitter.device
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                         device=dev),
                            torch.arange(width, dtype=torch.float32,
                                         device=dev), indexing="ij")
    px = xs + jitter[..., 0]
    py = ys + jitter[..., 1]
    d = torch.stack([px - width / 2.0, py - height / 2.0,
                     torch.full_like(px, focal)], dim=-1)
    d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    d = rotate_dirs(d, camera)
    o = torch.tensor(camera.position, dtype=torch.float32,
                     device=dev).expand(d.shape)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def primary_rays(generator: torch.Generator, camera: Camera, width: int,
                 height: int, focal: float):
    """Jittered primary rays; the jitter is drawn from ``generator`` (whose
    device is the rays' device)."""
    jitter = torch.rand((height, width, 2), generator=generator,
                        device=generator.device)
    return pixel_rays(jitter, camera, width, height, focal)
