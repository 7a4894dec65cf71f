"""Shared helpers of the tests that hold rlrpt_tpu_torch against rlrpt_tpu.

Inputs are made with numpy from fixed seeds and handed to both packages;
the JAX megakernels run in interpret mode at precision="highest".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlrpt_tpu.scene import build_scene as jax_build_scene
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu_torch.utils.convert import scene_from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The twins step over a few hundred slots; torch's thread pool only
    adds contention under the test runner's worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def kernel_seed(key) -> int:
    """The int seed the JAX megakernel launchers draw from their key."""
    return int(jax.random.randint(key, (1,), 0, jnp.iinfo(jnp.int32).max,
                                  dtype=jnp.int32)[0])


def torch_scene(jax_scene, device="cpu"):
    return scene_from_numpy(jax_scene.v0, jax_scene.v1, jax_scene.v2,
                            jax_scene.normal, jax_scene.diffuse_c,
                            jax_scene.emission, jax_scene.luminance,
                            jax_scene.n_surfaces, device=device)


def cornell_plus_clutter(n_extra: int = 250, seed: int = 7):
    """The Cornell box plus `n_extra` small random surface triangles inside
    it (JAX scene): 288 triangles pad to 512, two 256-triangle chunks, so
    the JAX launcher takes its streaming multi-chunk (AABB-culled) path."""
    c = jax_cornell_box()
    ns = c.n_surfaces
    rng = np.random.default_rng(seed)
    cen = rng.uniform(-0.9, 0.9, (n_extra, 3)).astype(np.float32)
    tri = cen[:, None, :] + rng.normal(0, 0.03, (n_extra, 3, 3)).astype(
        np.float32)
    rgb = rng.uniform(0.1, 0.9, (n_extra, 3)).astype(np.float32)
    a = np.asarray
    return jax_build_scene(
        np.concatenate([a(c.v0)[:ns], tri[:, 0]]),
        np.concatenate([a(c.v1)[:ns], tri[:, 1]]),
        np.concatenate([a(c.v2)[:ns], tri[:, 2]]),
        np.concatenate([a(c.diffuse_c)[:ns], rgb]),
        a(c.v0)[ns:], a(c.v1)[ns:], a(c.v2)[ns:], a(c.emission)[ns:])


def assert_frame_parity(img_t, aux_t, img_j, aux_j):
    """Per-pixel parity of two renders that draw the same samples.

    Only paths where f32 rounding flips a hit (or, guided, a uv bin) may
    differ: throughput factors are bitwise identical on both sides, and
    geometry differs in the last ulp (classic vs matmul Moller-Trumbore,
    FMA contraction, cos/sin).  So: >= 99% of pixels within atol 1e-4,
    rtol 1e-3; frame mean within 0.5%; avg path length within 1%.
    """
    img_t = np.asarray(img_t)
    img_j = np.asarray(img_j)
    assert img_t.shape == img_j.shape
    assert np.isfinite(img_t).all()
    close = np.isclose(img_t, img_j, atol=1e-4, rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    mt, mj = float(img_t.mean()), float(img_j.mean())
    assert abs(mt - mj) <= 0.005 * mj, (mt, mj)
    at, aj = float(aux_t["avg_path_length"]), float(aux_j["avg_path_length"])
    assert abs(at - aj) <= 0.01 * aj, (at, aj)

