"""The reference's triangle tables, built from the configuration's own data.

``cornell`` is the GPU engine's hard-coded Cornell box
(cornell_box_scene.cu): 36 surfaces in a 555-unit room, the blocks
included, then the 2 light triangles of the ceiling hole at power
14 * 0.9; every vertex scaled by 2/555, moved by -1 and flipped in x and
y.

A table row is what a closest-hit sweep reads: tris (T, 12) = [v0, 0,
v1 - v0, 0, v2 - v0, 0] and mat (T, 16) = [normal, diffuse, emission,
is_light, luminance, id, 0 x 4], surfaces before lights.  Normals are
normalize((v2 - v0) x (v1 - v0)) and luminance 0.5 (max + min) of the
colour, both in float32.
"""

from __future__ import annotations

import numpy as np
import torch

_BLUE = (0.15, 0.15, 0.75)
_WHITE = (0.75, 0.75, 0.75)
_RED = (0.75, 0.15, 0.15)
_GREEN = (0.15, 0.75, 0.15)
_YELLOW = (0.75, 0.75, 0.15)
_CYAN = (0.15, 0.75, 0.75)


class Tables:
    """A scene as the reference traces it."""

    def __init__(self, v0, v1, v2, rgb, power, n_surfaces: int):
        f = lambda a: np.asarray(a, np.float32).reshape(-1, 3)  # noqa: E731
        self.v0, self.v1, self.v2 = f(v0), f(v1), f(v2)
        self.rgb, self.power = f(rgb), f(power)
        self.n_surfaces = n_surfaces
        n = np.cross(self.v2 - self.v0, self.v1 - self.v0)
        self.normal = n / np.linalg.norm(n, axis=-1, keepdims=True)
        lum = lambda c: 0.5 * (c.max(axis=-1) + c.min(axis=-1))  # noqa: E731
        self.luminance = np.concatenate([lum(self.rgb[:n_surfaces]),
                                         lum(self.power[n_surfaces:])])

    @property
    def n_triangles(self) -> int:
        return self.v0.shape[0]

    def packed(self, device, ft=torch.float32):
        """(tris (T, 12), mat (T, 16)) on ``device`` in dtype ``ft``."""
        t = self.n_triangles
        z = np.zeros((t, 1), np.float32)
        tris = np.concatenate([self.v0, z, self.v1 - self.v0, z,
                               self.v2 - self.v0, z], axis=1)
        ids = np.arange(t)
        mat = np.concatenate([
            self.normal, self.rgb, self.power,
            (ids >= self.n_surfaces).astype(np.float32)[:, None],
            self.luminance[:, None].astype(np.float32),
            ids.astype(np.float32)[:, None], np.zeros((t, 4), np.float32)],
            axis=1)
        as_t = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a, np.float32), device=device).to(ft)
        return as_t(tris), as_t(mat)

    def luminance_tensor(self, device) -> torch.Tensor:
        return torch.as_tensor(self.luminance.astype(np.float32),
                               device=device)


def _assemble(surf, rgb, lights, power) -> Tables:
    surf = np.asarray(surf, np.float32).reshape(-1, 3, 3)
    lights = np.asarray(lights, np.float32).reshape(-1, 3, 3)
    rgb = np.asarray(rgb, np.float32).reshape(-1, 3)
    power = np.asarray(power, np.float32).reshape(-1, 3)
    v = np.concatenate([surf, lights])
    cols = np.concatenate([rgb, np.zeros((len(lights), 3), np.float32)])
    pw = np.concatenate([np.zeros((len(surf), 3), np.float32), power])
    return Tables(v[:, 0], v[:, 1], v[:, 2], cols, pw, len(surf))


def _flip(v: np.ndarray, scale: float) -> np.ndarray:
    v = v * scale - 1.0
    v[..., 0] *= -1.0
    v[..., 1] *= -1.0
    return v


def _box(A, B, C, D, E, F, G, H, colour):
    return [(E, B, A, colour), (E, F, B, colour), (F, D, B, colour),
            (F, H, D, colour), (H, C, D, colour), (H, G, C, colour),
            (G, E, C, colour), (E, A, C, colour), (G, F, E, colour),
            (G, H, F, colour)]


def cornell() -> Tables:
    l = 555.0  # noqa: E741
    A = (l, 0, 0); B = (0, 0, 0); C = (l, 0, l); D = (0, 0, l)  # noqa: E702
    E = (l, l, 0); F = (0, l, 0); G = (l, l, l); H = (0, l, l)  # noqa: E702
    I = (l / 3, l, 2 * l / 3); J = (2 * l / 3, l, 2 * l / 3)  # noqa: E702,E741
    K = (l / 3, l, l / 3); L = (2 * l / 3, l, l / 3)  # noqa: E702
    tris = [
        (C, B, A, _GREEN), (C, D, B, _GREEN),                     # floor
        (A, E, C, _WHITE), (C, E, G, _WHITE),                     # left
        (F, B, D, _WHITE), (H, F, D, _WHITE),                     # right
        (F, H, I, _CYAN), (F, I, K, _CYAN), (F, K, E, _CYAN),     # ceiling
        (K, L, E, _CYAN), (L, G, E, _CYAN), (L, J, G, _CYAN),
        (I, G, J, _CYAN), (H, G, I, _CYAN),
        (G, D, C, _YELLOW), (G, H, D, _YELLOW),                   # back
    ]
    tris += _box((240, 0, 234), (80, 0, 185), (190, 0, 392), (32, 0, 345),
                 (240, 165, 234), (80, 165, 185), (190, 165, 392),
                 (32, 165, 345), _BLUE)
    tris += _box((443, 0, 247), (285, 0, 296), (492, 0, 406), (334, 0, 456),
                 (443, 330, 247), (285, 330, 296), (492, 330, 406),
                 (334, 330, 456), _RED)
    surf = _flip(np.asarray([t[:3] for t in tris], np.float64), 2.0 / l)
    lights = _flip(np.asarray([(K, I, J), (K, J, L)], np.float64), 2.0 / l)
    power = 14.0 * np.asarray([[0.9, 0.9, 0.9]] * 2, np.float32)
    return _assemble(surf, [t[3] for t in tris], lights, power)

