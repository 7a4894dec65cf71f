"""The reference's tables of the CPU engine's second built-in room.

Old_CPU_Rendering_Engine/Source/scenes/monte_carlo_test_scene.cpp:35-89:
the Cornell room's 555-unit shell without its two blocks (commented out
there), white floor, ceiling and back wall, a red left and a blue right
wall, and a polygon light over the ceiling's hole (K, I, J, L),
fan-triangulated as AreaLightPlane does (area_light_plane.cpp:14-22:
AreaLight(v0, v[i], v[i + 1]) for each step of the fan), at power
5 * (1, 1, 0.9).  Every vertex is scaled by 2/555, moved by -1 and flipped
in x and y.  16 surfaces, then 2 light triangles.

Where this departs from the engine, as the configuration states: the room
is traced by the GPU engine's arithmetic (``pathtrace.py``: its camera,
bounce cap, sector grid and learning rule), not by the CPU engine's
recursive tracer at its own 512x512, 2 bounces, 16 spp and 25x25 grid;
the light is two emitting triangles of the scene, as in the GPU engine's
Cornell box, not a separate AreaLight list sampled for direct light.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.scenes import (_BLUE, _RED, _WHITE, Tables,
                                        _assemble, _flip)


def light_fan(polygon) -> list:
    """AreaLightPlane's fan: (v0, v[i], v[i + 1]) for i in 1 .. n - 2."""
    return [(polygon[0], polygon[i], polygon[i + 1])
            for i in range(1, len(polygon) - 1)]


def tables() -> Tables:
    """The room's tables (a function not named test_*, so that a test
    runner collecting this file finds nothing to run)."""
    l = 555.0  # noqa: E741
    A = (l, 0, 0); B = (0, 0, 0); C = (l, 0, l); D = (0, 0, l)  # noqa: E702
    E = (l, l, 0); F = (0, l, 0); G = (l, l, l); H = (0, l, l)  # noqa: E702
    I = (l / 3, l, 2 * l / 3); J = (2 * l / 3, l, 2 * l / 3)  # noqa: E702,E741
    K = (l / 3, l, l / 3); L = (2 * l / 3, l, l / 3)  # noqa: E702
    tris = [
        (C, B, A, _WHITE), (C, D, B, _WHITE),                     # floor
        (A, E, C, _RED), (C, E, G, _RED),                         # left
        (F, B, D, _BLUE), (H, F, D, _BLUE),                       # right
        (F, H, I, _WHITE), (F, I, K, _WHITE), (F, K, E, _WHITE),  # ceiling
        (K, L, E, _WHITE), (L, G, E, _WHITE), (L, J, G, _WHITE),
        (I, G, J, _WHITE), (H, G, I, _WHITE),
        (G, D, C, _WHITE), (G, H, D, _WHITE),                     # back
    ]
    surf = _flip(np.asarray([t[:3] for t in tris], np.float64), 2.0 / l)
    fan = light_fan([K, I, J, L])
    lights = _flip(np.asarray(fan, np.float64), 2.0 / l)
    power = 5.0 * np.asarray([[1.0, 1.0, 0.9]] * len(fan), np.float32)
    return _assemble(surf, [t[3] for t in tris], lights, power)
