"""rlrpt_tpu_torch default megakernel (B1's plain twin) vs the JAX
megakernel in interpret mode, per pixel, and vs the port's plain default
tracer, statistically.

The twin draws the JAX kernel's samples (same int seed, counter hash,
n_slots and pix_mux), so images agree per pixel up to paths where f32
rounding flips a hit.  The CUDA kernel itself is held against the twin on
the card by chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

from rlrpt_tpu import config as jconfig
from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.ops import megakernel as jmk
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RenderConfig
from rlrpt_tpu_torch.integrators.default_tracer import render_default
from rlrpt_tpu_torch.ops import megakernel as mk
from rlrpt_tpu_torch.scene import cornell_box
from _torch_parity import (assert_frame_parity, cornell_plus_clutter,  # noqa: F401
                           kernel_seed, one_torch_thread, torch_scene)

CAM = (0.0, 0.0, -3.0)


def _both(jax_scene, key, r_tile, pix_mux, **cfg):
    """(port twin render, JAX interpret render) of one frame."""
    img_j, aux_j = jmk.render_default_mega(
        key, jax_scene, JCamera.create(CAM), jconfig.RenderConfig(**cfg),
        r_tile=r_tile, pix_mux=pix_mux, interpret=True, precision="highest")
    img_t, aux_t = mk.render_default_mega(
        kernel_seed(key), torch_scene(jax_scene), Camera.create(CAM),
        RenderConfig(**cfg), device="cpu", r_tile=r_tile, pix_mux=pix_mux)
    return (img_t, aux_t), (img_j, aux_j)


@pytest.mark.parametrize("rr", [False, True], ids=["rr_off", "rr_on"])
def test_twin_matches_jax_cornell(rr):
    (img_t, aux_t), (img_j, aux_j) = _both(
        jax_cornell_box(), jax.random.PRNGKey(0), 128, 4, width=32,
        height=32, samples_per_pixel=4, max_ray_bounces=10,
        russian_roulette=rr)
    assert_frame_parity(img_t, aux_t, img_j, aux_j)


def test_twin_matches_jax_multichunk():
    """288 triangles pad to 512: the JAX launcher streams two chunks (with
    its AABB cull); the port sweeps every triangle, first-tested wins."""
    scene = cornell_plus_clutter()
    assert jmk._t_pad(scene.n_triangles) == 2 * jmk.T_CHUNK
    (img_t, aux_t), (img_j, aux_j) = _both(
        scene, jax.random.PRNGKey(1), 128, 4, width=24, height=24,
        samples_per_pixel=4, max_ray_bounces=8)
    assert_frame_parity(img_t, aux_t, img_j, aux_j)


@pytest.mark.parametrize("n", [1, 8, 38, 255, 256, 257, 600])
def test_t_pad_matches_jax(n):
    assert mk._t_pad(n) == jmk._t_pad(n)


@pytest.fixture(scope="module")
def renders():
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=8,
                       max_ray_bounces=10)
    cam = Camera.create(CAM)
    img_m, aux_m = mk.render_default_mega(11, cornell_box(), cam, cfg,
                                          device="cpu", r_tile=128,
                                          pix_mux=4)
    img_d, aux_d = render_default(7, cornell_box(), cam, cfg, device="cpu")
    return img_m.numpy(), aux_m, img_d.numpy(), aux_d


def test_twin_matches_plain_tracer(renders):
    """Same estimator as the plain tracer (tolerances of
    tests/test_megakernel.py): 8 spp at 32x32 keeps the frame-mean MC
    error far below 10%."""
    img_m, aux_m, img_d, aux_d = renders
    assert np.isfinite(img_m).all() and img_m.min() >= 0.0
    assert img_m.max() > 0.05
    assert abs(img_m.mean() - img_d.mean()) < 0.1 * max(img_d.mean(), 1e-6)
    assert abs(float(aux_m["avg_path_length"])
               - float(aux_d["avg_path_length"])) < 0.5


def test_pixel_mapping_no_holes(renders):
    """Every pixel receives its spp samples: a mis-mapped slot->pixel
    unpack leaves dark holes."""
    img_m, _, img_d, _ = renders
    dark_m = int((img_m.max(axis=-1) == 0.0).sum())
    dark_d = int((img_d.max(axis=-1) == 0.0).sum())
    assert dark_m <= dark_d + 25


def test_wrapper_validates_inputs():
    tris, mat = mk.pack_scene(cornell_box())
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1)
    with pytest.raises(ValueError, match="contiguous float32"):
        mk.mega_default_frame(0, (0.0,) * 7, tris.double(), mat, cfg, 128, 1)
    with pytest.raises(ValueError, match=r"\(T, 12\)"):
        mk.mega_default_frame(0, (0.0,) * 7, tris[:, :9].contiguous(), mat,
                              cfg, 128, 1)
    with pytest.raises(ValueError, match="no kernel"):
        mk.mega_default_frame(0, (0.0,) * 7, tris.to("meta"),
                              mat.to("meta"), cfg, 128, 1)
    assert mk.KERNEL.launches == 0   # the CPU route never counts a launch


def test_frame_layout():
    """rad is (pix_mux, n_slots, 3): pixel p = slot + k*n_slots."""
    cfg = RenderConfig(width=10, height=7, samples_per_pixel=2,
                       max_ray_bounces=4)
    tris, mat = mk.pack_scene(cornell_box())
    n_slots = mk.n_slots_for(cfg.n_pixels, 16, 3)
    assert n_slots == 32
    rad, path_sum, iters = mk.mega_default_frame(
        5, mk.camera_vector(Camera.create(CAM)), tris, mat, cfg, n_slots, 3)
    assert rad.shape == (3, n_slots, 3) and path_sum.shape == (n_slots,)
    flat = rad.reshape(-1, 3)
    assert torch.all(flat[cfg.n_pixels:] == 0)
    assert float(path_sum.sum()) >= cfg.n_pixels * 2   # >= 1 segment each
    assert int(iters.max()) > 0


def test_lane_efficiency_of_slot_iterations():
    """The sweep tool's lane efficiency: active slot-iterations over the
    lane-iterations a group of slots spends while its longest slot runs."""
    from rlrpt_tpu_torch.tools.mega_sweep import lane_efficiency
    flat = torch.full((256,), 7, dtype=torch.int32)
    assert lane_efficiency(flat, 32) == lane_efficiency(flat, 128) == 1.0
    one = torch.zeros((64,), dtype=torch.int32)
    one[3] = 8
    assert lane_efficiency(one, 32) == 8 / (32 * 8)
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1,
                       max_ray_bounces=20)
    tris, mat = mk.pack_scene(cornell_box())
    n_slots = mk.n_slots_for(cfg.n_pixels, 128, 1)
    _, path_sum, iters = mk.mega_default_frame(
        9, mk.camera_vector(Camera.create(CAM)), tris, mat, cfg, n_slots, 1)
    # pix_mux 1, 1 spp: a slot is active for exactly its path's segments
    assert int(iters.sum()) == int(path_sum.sum())
    warp, block = lane_efficiency(iters, 32), lane_efficiency(iters, 128)
    assert 0.0 < block <= warp <= 1.0
