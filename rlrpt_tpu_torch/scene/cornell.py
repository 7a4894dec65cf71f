"""Hard-coded scenes (counterpart of ``rlrpt_tpu/scene/cornell.py``).

``cornell_box`` re-expresses get_cornell_shapes
(ref: GPU_Rendering_Engine/Source/scenes/cornell_box_scene.cu:4-245):
walls, an 8-triangle ceiling with a 2-triangle light hole, short and tall
blocks; every vertex is scaled by 2/555, translated by -1 and flipped in
x and y; light power diffuse_p = 14 * (0.9, 0.9, 0.9).
``monte_carlo_test_scene`` is the CPU engine's second built-in room (the
``test_room`` preset).
"""

from __future__ import annotations

import numpy as np

from rlrpt_tpu_torch.scene.scene import Scene, build_scene

_BLUE = (0.15, 0.15, 0.75)
_WHITE = (0.75, 0.75, 0.75)
_RED = (0.75, 0.15, 0.15)
_GREEN = (0.15, 0.75, 0.15)
_YELLOW = (0.75, 0.75, 0.15)
_CYAN = (0.15, 0.75, 0.75)


def _room(l: float):
    A = (l, 0, 0); B = (0, 0, 0); C = (l, 0, l); D = (0, 0, l)  # noqa: E702
    E = (l, l, 0); F = (0, l, 0); G = (l, l, l); H = (0, l, l)  # noqa: E702
    I = (l / 3, l, 2 * l / 3); J = (2 * l / 3, l, 2 * l / 3)  # noqa: E702,E741
    K = (l / 3, l, l / 3); L = (2 * l / 3, l, l / 3)  # noqa: E702

    tris = [
        # floor
        (C, B, A, _GREEN), (C, D, B, _GREEN),
        # left wall
        (A, E, C, _WHITE), (C, E, G, _WHITE),
        # right wall
        (F, B, D, _WHITE), (H, F, D, _WHITE),
        # ceiling (8 tris around the light hole)
        (F, H, I, _CYAN), (F, I, K, _CYAN), (F, K, E, _CYAN), (K, L, E, _CYAN),
        (L, G, E, _CYAN), (L, J, G, _CYAN), (I, G, J, _CYAN), (H, G, I, _CYAN),
        # back wall
        (G, D, C, _YELLOW), (G, H, D, _YELLOW),
    ]
    lights = [(K, I, J), (K, J, L)]
    return tris, lights


def _block(A, B, C, D, E, F, G, H, colour):
    return [
        (E, B, A, colour), (E, F, B, colour),
        (F, D, B, colour), (F, H, D, colour),
        (H, C, D, colour), (H, G, C, colour),
        (G, E, C, colour), (E, A, C, colour),
        (G, F, E, colour), (G, H, F, colour),
    ]


def _normalise(v: np.ndarray, l: float) -> np.ndarray:
    """(2/l) scale, -1 translate, flip x and y
    (ref: cornell_box_scene.cu:163-199)."""
    v = v * (2.0 / l) - 1.0
    v[..., 0] *= -1.0
    v[..., 1] *= -1.0
    return v


def cornell_box(device="cuda") -> Scene:
    """The 38-triangle Cornell box: 36 surfaces, then 2 light triangles."""
    l = 555.0  # noqa: E741
    tris, lights = _room(l)
    tris += _block(
        (240, 0, 234), (80, 0, 185), (190, 0, 392), (32, 0, 345),
        (240, 165, 234), (80, 165, 185), (190, 165, 392), (32, 165, 345),
        _BLUE,
    )
    tris += _block(
        (443, 0, 247), (285, 0, 296), (492, 0, 406), (334, 0, 456),
        (443, 330, 247), (285, 330, 296), (492, 330, 406), (334, 330, 456),
        _RED,
    )

    sv = _normalise(np.asarray([[t[0], t[1], t[2]] for t in tris],
                               np.float64), l)
    rgb = np.asarray([t[3] for t in tris], np.float32)
    lv = _normalise(np.asarray(lights, np.float64), l)
    diffuse_p = 14.0 * np.asarray([[0.9, 0.9, 0.9]] * len(lights), np.float32)
    return build_scene(sv[:, 0], sv[:, 1], sv[:, 2], rgb,
                       lv[:, 0], lv[:, 1], lv[:, 2], diffuse_p, device=device)


def polygon_light(vertices) -> list:
    """Fan-triangulate a polygon light into area-light triangles, the CPU
    engine's AreaLightPlane (ref: Old_CPU_Rendering_Engine/Source/lights/
    area_light_plane.cpp:4-22: AreaLight(v0, v[i], v[i+1]) per fan step).

    vertices: sequence of (3,) points; returns a list of (v0, v1, v2)."""
    v = [tuple(p) for p in vertices]
    return [(v[0], v[i], v[i + 1]) for i in range(1, len(v) - 1)]


def monte_carlo_test_scene(device="cuda") -> Scene:
    """The CPU engine's extra hard-coded test room (ref:
    Old_CPU_Rendering_Engine/Source/scenes/monte_carlo_test_scene.cpp):
    the Cornell room shell without blocks (commented out there), white
    floor, ceiling and back, red left wall, blue right wall (:35-89), and
    the polygon ceiling light over (K, I, J, L) with diffuse_p =
    5 * (1, 1, 0.9): 16 surfaces, then 2 light triangles."""
    l = 555.0  # noqa: E741
    A = (l, 0, 0); B = (0, 0, 0); C = (l, 0, l); D = (0, 0, l)  # noqa: E702
    E = (l, l, 0); F = (0, l, 0); G = (l, l, l); H = (0, l, l)  # noqa: E702
    I = (l / 3, l, 2 * l / 3); J = (2 * l / 3, l, 2 * l / 3)  # noqa: E702,E741
    K = (l / 3, l, l / 3); L = (2 * l / 3, l, l / 3)  # noqa: E702
    tris = [
        (C, B, A, _WHITE), (C, D, B, _WHITE),                    # floor
        (A, E, C, _RED), (C, E, G, _RED),                        # left wall
        (F, B, D, _BLUE), (H, F, D, _BLUE),                      # right wall
        (F, H, I, _WHITE), (F, I, K, _WHITE), (F, K, E, _WHITE),  # ceiling
        (K, L, E, _WHITE), (L, G, E, _WHITE), (L, J, G, _WHITE),
        (I, G, J, _WHITE), (H, G, I, _WHITE),
        (G, D, C, _WHITE), (G, H, D, _WHITE),                    # back wall
    ]
    sv = _normalise(np.asarray([[t[0], t[1], t[2]] for t in tris],
                               np.float64), l)
    rgb = np.asarray([t[3] for t in tris], np.float32)
    lv = _normalise(np.asarray(polygon_light([K, I, J, L]), np.float64), l)
    diffuse_p = 5.0 * np.asarray([[1.0, 1.0, 0.9]] * len(lv), np.float32)
    return build_scene(sv[:, 0], sv[:, 1], sv[:, 2], rgb,
                       lv[:, 0], lv[:, 1], lv[:, 2], diffuse_p, device=device)
