"""Frame means of the JAX package's pretrained tracer and of its default
path tracer, from one DyNet model, on the CPU: the reference's own
figures, beside which the port's pretrained frames are read.

    JAX_PLATFORMS=cpu python scripts/jax_deep_means.py MODEL \
        [--size 64] [--spp 32] [--frames 4]

Renders --frames frames of each tracer on the Cornell box with the
80-bounce cap: ``rlrpt_tpu.deep.pretrained.render_frame_pretrained`` (the
lockstep, epsilon 0, on the exact f32 XLA hit sweep) and
``rlrpt_tpu.integrators.default_tracer.render_default``.  Prints each
tracer's mean over its frames with the standard error of that mean:
pixels are independent, so its variance is the sum of the pixels'
variances across the frames over frames x pixels^2.  Imports JAX; it is
no part of rlrpt_tpu_torch.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rlrpt_tpu.camera import Camera  # noqa: E402
from rlrpt_tpu.config import (DeepLearningConfig,  # noqa: E402
                              RadianceVolumeConfig, RenderConfig)
from rlrpt_tpu.deep.pretrained import render_frame_pretrained  # noqa: E402
from rlrpt_tpu.integrators.default_tracer import render_default  # noqa: E402
from rlrpt_tpu.nn.dynet_io import load_dynet_model  # noqa: E402
from rlrpt_tpu.scene import presets  # noqa: E402


def mean_and_error(frames) -> tuple[float, float]:
    """(grand mean, its standard error) of (K, H, W, 3) frames."""
    lum = np.asarray(frames, np.float64).mean(-1)
    k, n = lum.shape[0], lum[0].size
    return float(lum.mean()), float(np.sqrt(lum.var(0, ddof=1).sum() / k)
                                    / n)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model")
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--spp", type=int, default=32)
    p.add_argument("--frames", type=int, default=4)
    args = p.parse_args(argv)
    preset = presets.get("cornell")
    scene, camera = preset.load(), Camera.create(preset.camera_position)
    cfg = RenderConfig(width=args.size, height=args.size,
                       samples_per_pixel=args.spp, max_ray_bounces=80)
    params = load_dynet_model(args.model)
    keys = jax.random.split(jax.random.PRNGKey(0), 2 * args.frames)
    print(f"Cornell {args.size}x{args.size}, {args.spp} spp, {args.frames} "
          f"frames each, {jax.default_backend()} backend")
    means = {}
    for name, fn in (
            ("pretrained", lambda k: render_frame_pretrained(
                k, scene, camera, params, cfg, RadianceVolumeConfig(),
                DeepLearningConfig(), use_pallas=False)),
            ("default", lambda k: render_default(k, scene, camera, cfg))):
        t0 = time.perf_counter()
        frames = [np.asarray(fn(k)[0]) for k in (
            keys[:args.frames] if name == "pretrained"
            else keys[args.frames:])]
        means[name] = mean_and_error(frames)
        print(f"{name}: mean {means[name][0]:.6f} +- {means[name][1]:.6f} "
              f"({time.perf_counter() - t0:.1f} s)")
    (m_p, e_p), (m_d, e_d) = means["pretrained"], means["default"]
    rel = m_p / m_d - 1.0
    err = abs(m_p / m_d) * np.hypot(e_p / m_p, e_d / m_d)
    print(f"pretrained vs default: {rel:+.4%} +- {err:.4%}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
