"""rlrpt_tpu_torch guided megakernel (B3's plain twin) and the binned-Q
host helpers vs rlrpt_tpu.

The CDF rebuild agrees to 1 bf16 ulp (torch's sum and scan round in
another order than XLA's); the guided twin draws the JAX kernel's
samples, so images agree per pixel up to paths where f32 rounding flips a
hit or a uv bin.  The CUDA kernel is held against the twin on the
card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlrpt_tpu import config as jconfig
from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.ops import guided_mega as jgm
from rlrpt_tpu.ops import guided_mega_train as jgt
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RenderConfig
from rlrpt_tpu_torch.ops import guided_mega as gm
from rlrpt_tpu_torch.ops import guided_mega_train as gt
from rlrpt_tpu_torch.ops import megakernel as mk
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.utils.convert import (bin_q_from_numpy,
                                           tri_bin_cdf_from_numpy)
from _torch_parity import (assert_frame_parity, cornell_plus_clutter,  # noqa: F401
                           kernel_seed, one_torch_thread, torch_scene)

CAM = (0.0, 0.0, -3.0)
T_PAD = 40            # cornell: 38 triangles


def _q(uv_bins: int, sector_grid: int, skew: float = 0.0, seed: int = 0):
    """Initial binned Q, skewed per entry by exp(skew * U[0, 1))."""
    q, _ = jgt.init_bin_q(T_PAD, uv_bins, sector_grid,
                          100.0 / sector_grid ** 2)
    rng = np.random.default_rng(seed)
    return (np.asarray(q)
            * np.exp(skew * rng.random(q.shape))).astype(np.float32)


def test_init_bin_q_and_luminance_equal():
    for ub, g in ((4, 11), (2, 12), (1, 11)):
        qj, vj = jgt.init_bin_q(T_PAD, ub, g, 100.0 / g ** 2)
        qt, vt = gt.init_bin_q(T_PAD, ub, g, 100.0 / g ** 2)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(
            gt.bin_luminance(cornell_box(), T_PAD, ub).numpy(),
            np.asarray(jgt.bin_luminance(jax_cornell_box(), T_PAD, ub)))
    q, v = bin_q_from_numpy(np.asarray(qj), np.asarray(vj))
    assert q.dtype == v.dtype == torch.float32 and q.shape == qj.shape


@pytest.mark.parametrize("sector_grid", [11, 12])
@pytest.mark.parametrize("mix", [0.0, 0.2])
def test_rebuild_bin_cdf_bit_equal(sector_grid, mix):
    q = _q(4, sector_grid, skew=3.0, seed=sector_grid)
    tj = jgt.rebuild_bin_cdf(jnp.asarray(q), sector_grid, 4, T_PAD,
                             defensive_mix=mix)
    tt = gt.rebuild_bin_cdf(torch.from_numpy(q), sector_grid, 4, T_PAD,
                            defensive_mix=mix)
    assert tt.cdf.dtype == torch.bfloat16
    assert (tt.sector_grid, tt.uv_bins, tt.t_pad) == (sector_grid, 4, T_PAD)
    # Every entry is positive, so bf16 bit patterns order as the values:
    # at most 1 ulp apart, and rarely that (1 of 92,160 entries at 12x12,
    # none elsewhere; 23 of 1,638,400 over 20 skewed tables).
    ulps = np.abs(tt.cdf.view(torch.int16).numpy().astype(np.int32)
                  - np.asarray(tj.cdf).view(np.int16).astype(np.int32))
    assert ulps.max() <= 1
    assert (ulps > 0).sum() <= 1e-4 * ulps.size, (ulps > 0).sum()
    # the numpy hand-over of a bf16 table is exact
    tc = tri_bin_cdf_from_numpy(np.asarray(tj.cdf, np.float32),
                                sector_grid, 4, T_PAD)
    np.testing.assert_array_equal(tc.cdf.view(torch.int16).numpy(),
                                  np.asarray(tj.cdf).view(np.int16))


@pytest.mark.parametrize("uv_bins,skew", [(4, 0.0), (4, 3.0), (2, 3.0)],
                         ids=["initial_uv4", "skewed_uv4", "skewed_uv2"])
def test_twin_matches_jax(uv_bins, skew):
    """pix_mux 1 (the port's default): a flipped path then changes one
    pixel's remaining samples only, not the slot's later pixels too."""
    q = _q(uv_bins, 11, skew)
    tj = jgt.rebuild_bin_cdf(jnp.asarray(q), 11, uv_bins, T_PAD)
    tt = gt.rebuild_bin_cdf(torch.from_numpy(q), 11, uv_bins, T_PAD)
    key = jax.random.PRNGKey(1)
    kw = dict(width=32, height=32, samples_per_pixel=4, max_ray_bounces=10)
    img_j, aux_j = jgm.render_guided_mega(
        key, jax_cornell_box(), JCamera.create(CAM), tj,
        jconfig.RenderConfig(**kw), r_tile=128, pix_mux=1, interpret=True,
        precision="highest")
    img_t, aux_t = gm.render_guided_mega(
        kernel_seed(key), cornell_box(), Camera.create(CAM), tt,
        RenderConfig(**kw), device="cpu", r_tile=128, pix_mux=1)
    assert_frame_parity(img_t, aux_t, img_j, aux_j)


def test_guided_unbiased_under_skewed_table():
    """A non-uniform table leaves the image mean unchanged (pdf == the
    actual sampling probability of every sector); tolerance of
    tests/test_guided_mega.py:102-126.  The skew is milder than the
    parity tests': with a 20:1 spread inside a column, sectors whose
    probability is below the bf16 CDF's resolution round to hi == lo and
    are never drawn, which biases the reference and the port alike."""
    cfg = RenderConfig(width=48, height=48, samples_per_pixel=16,
                       max_ray_bounces=6)
    tb = gt.rebuild_bin_cdf(torch.from_numpy(_q(2, 11, skew=1.0, seed=5)),
                            11, 2, T_PAD)
    cam = Camera.create(CAM)
    img_g, _ = gm.render_guided_mega(11, cornell_box(), cam, tb, cfg,
                                     device="cpu", r_tile=512, pix_mux=2)
    img_d, _ = mk.render_default_mega(13, cornell_box(), cam, cfg,
                                      device="cpu", r_tile=512, pix_mux=2)
    assert torch.isfinite(img_g).all()
    mg, md = float(img_g.mean()), float(img_d.mean())
    assert abs(mg - md) / md < 0.08, (mg, md)


def test_validation_errors():
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1,
                       max_ray_bounces=2)
    cam = Camera.create(CAM)
    q, _ = gt.init_bin_q(T_PAD + 8, 2, 11, 1.0)
    with pytest.raises(ValueError, match="t_pad"):
        gm.render_guided_mega(0, cornell_box(), cam,
                              gt.rebuild_bin_cdf(q, 11, 2, T_PAD + 8), cfg,
                              device="cpu")
    clutter = torch_scene(cornell_plus_clutter())
    t_pad = mk._t_pad(clutter.n_triangles)
    q, _ = gt.init_bin_q(t_pad, 4, 11, 1.0)
    with pytest.raises(ValueError, match="uv_bins=1"):
        gm.render_guided_mega(0, clutter, cam,
                              gt.rebuild_bin_cdf(q, 11, 4, t_pad), cfg,
                              device="cpu")
    # per-triangle tables do run on multi-chunk scenes
    q, _ = gt.init_bin_q(t_pad, 1, 11, 1.0)
    img, _ = gm.render_guided_mega(0, clutter, cam,
                                   gt.rebuild_bin_cdf(q, 11, 1, t_pad), cfg,
                                   device="cpu")
    assert torch.isfinite(img).all() and float(img.max()) > 0.0


def test_concentric_dir_matches_jax():
    rng = np.random.default_rng(2)
    gx, gy = rng.random((2, 512)).astype(np.float32)
    n = rng.normal(size=(512, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    j = jgm._concentric_dir(*(jnp.asarray(a) for a in (gx, gy, *n.T)),
                            jnp.zeros(512, jnp.float32),
                            jnp.ones(512, jnp.float32))
    t = gm._concentric_dir(*(torch.from_numpy(a.copy())
                             for a in (gx, gy, *n.T)))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
