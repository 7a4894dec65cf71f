"""rlrpt_tpu_torch learning frame (B2's plain twin) vs rlrpt_tpu.

The JAX kernel runs in interpret mode at precision="highest" with one ray
tile covering every slot (r_tile 512 >= n_slots), which is the port's
one-batch-per-iteration schedule.  Both sides get the same table each
frame (the JAX rebuild, handed over with tri_bin_cdf_from_numpy) and carry
their own q and visits.  The CUDA kernel is held against the twin on the
card by chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

from rlrpt_tpu import config as jconfig
from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.ops import guided_mega_train as jgt
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.ops import guided_mega as gm
from rlrpt_tpu_torch.ops import guided_mega_train as gt
from rlrpt_tpu_torch.ops import hemisphere as hs
from rlrpt_tpu_torch.ops import megakernel as mk
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.utils.convert import tri_bin_cdf_from_numpy
from _torch_parity import (assert_frame_parity, cornell_plus_clutter,  # noqa: F401
                           kernel_seed, one_torch_thread, torch_scene)

CAM = (0.0, 0.0, -3.0)
T_PAD = 40            # cornell: 38 triangles
G = 11
THR = RadianceVolumeConfig(grid_resolution=G).radiance_threshold
INIT = RadianceVolumeConfig(grid_resolution=G).initial_radiance


def _train(uv_bins: int, n_frames: int, cfg: RenderConfig, seed0: int,
           pix_mux: int = 2, r_tile: int = 512):
    """Twin frames from the initial Q; returns (q, visits, per-frame
    (image, aux))."""
    q, v = gt.init_bin_q(T_PAD, uv_bins, G, INIT)
    outs = []
    for f in range(n_frames):
        tb = gt.rebuild_bin_cdf(q, G, uv_bins, T_PAD)
        img, q, v, aux = gt.render_sarsa_mega_train(
            seed0 + f, cornell_box(), Camera.create(CAM), tb, q, v, cfg, THR,
            device="cpu", r_tile=r_tile, pix_mux=pix_mux)
        outs.append((img, aux))
    return q, v, outs


@pytest.mark.parametrize("uv_bins,rr,key0", [(2, False, 10), (4, False, 10),
                                            (4, True, 20)],
                         ids=["uv2", "uv4", "uv4_rr"])
def test_twin_matches_jax(uv_bins, rr, key0):
    """Two frames, 32x32, 4 spp, 6 bounces, pix_mux 2, one tile.

    The image, avg path and iterations agree as the guided frame does
    (the paths never depend on Q).  Visits and Q agree where the two
    sides' hits agree: the JAX kernel's matmul-form Moller-Trumbore flips
    a few near-ties (e.g. rays into the edge where the tall block meets
    the ceiling), which moves a transition to another bin, or the rest of
    a slot's samples to other RNG keys; Q then carries the change into
    every target that bootstraps from that bin's irradiance.  Measured
    (CPU): visits equal on >= 99.26% of entries with >= 99.17% of the
    visit mass in the same cells; Q within rtol 1e-3 on >= 98.79% of
    entries and within 1e-1 on >= 99.45%.  Where no hit flips, the two
    differ by the JAX side's bf16 hi/lo split of targets and irradiance
    (about 1e-5 relative)."""
    kw = dict(width=32, height=32, samples_per_pixel=4, max_ray_bounces=6,
              russian_roulette=rr)
    qj, vj = jgt.init_bin_q(T_PAD, uv_bins, G, INIT)
    qt, vt = torch.from_numpy(np.array(qj)), torch.from_numpy(np.array(vj))
    for f in range(2):
        tj = jgt.rebuild_bin_cdf(qj, G, uv_bins, T_PAD)
        tt = tri_bin_cdf_from_numpy(np.asarray(tj.cdf, np.float32), G,
                                    uv_bins, T_PAD)
        key = jax.random.PRNGKey(key0 + f)
        img_j, qj2, vj2, aux_j = jgt.render_sarsa_mega_train(
            key, jax_cornell_box(), JCamera.create(CAM), tj, qj, vj,
            jconfig.RenderConfig(**kw), THR, r_tile=512, pix_mux=2,
            interpret=True, precision="highest")
        img_t, qt2, vt2, aux_t = gt.render_sarsa_mega_train(
            kernel_seed(key), cornell_box(), Camera.create(CAM), tt, qt, vt,
            RenderConfig(**kw), THR, device="cpu", r_tile=512, pix_mux=2)
        assert_frame_parity(img_t, aux_t, img_j, aux_j)
        # JAX reports its loop count rounded up to the unroll of 2
        it_j = int(aux_j["wavefront_iterations"])
        assert 0 <= it_j - int(aux_t["wavefront_iterations"]) <= 2
        td_t = int(aux_t["td_scatter_count"])
        td_j = int(aux_j["td_scatter_count"])
        assert abs(td_t - td_j) <= 0.005 * td_j, (td_t, td_j)
        # the visit invariant, exact on each side
        assert float((vt2 - vt).sum()) == td_t
        assert float(np.asarray(vj2 - vj).sum()) == td_j

        va, vb = np.asarray(vj2), vt2.numpy()
        assert (va == vb).mean() >= 0.99, (va == vb).mean()
        assert np.abs(va - vb).sum() <= 0.015 * va.sum()
        qa, qb = np.asarray(qj2)[:G * G], qt2.numpy()[:G * G]
        for rtol, share in ((1e-3, 0.98), (1e-1, 0.99)):
            frac = np.isclose(qb, qa, rtol=rtol, atol=0.0).mean()
            assert frac >= share, (rtol, frac)
        qj, vj, qt, vt = qj2, vj2, qt2, vt2


def test_image_is_the_guided_frame_and_inputs_untouched():
    """The paths never read Q: a learning frame's rad, path_sum and iters
    are the guided twin's bit for bit; q and visits come back new."""
    cfg = RenderConfig(width=24, height=24, samples_per_pixel=4,
                       max_ray_bounces=8, russian_roulette=True)
    rng = np.random.default_rng(4)
    q, v = gt.init_bin_q(T_PAD, 2, G, INIT)
    q = q * torch.from_numpy(np.exp(rng.random(q.shape)).astype(np.float32))
    v = torch.from_numpy(rng.integers(0, 5, v.shape).astype(np.float32))
    q0, v0 = q.clone(), v.clone()
    tb = gt.rebuild_bin_cdf(q, G, 2, T_PAD)
    cdf_t = tb.cdf.T.contiguous()
    cam = mk.camera_vector(Camera.create(CAM))
    scene = cornell_box()
    tris, mat = mk.pack_scene(scene)
    n_slots = mk.n_slots_for(cfg.n_pixels, 128, 2)
    rad, path_sum, iters, q1, v1, td = gt.mega_train_frame(
        321, cam, tris, mat, cdf_t, gt.bin_luminance(scene, T_PAD, 2)[0],
        hs.sector_cos_thetas(G).contiguous(), q, v, G, 2, THR, cfg,
        n_slots, 2)
    ref = gm.mega_guided_frame(321, cam, tris, mat, cdf_t, G, 2, cfg,
                               n_slots, 2)
    for a, b in zip((rad, path_sum, iters), ref):
        assert torch.equal(a, b)
    assert torch.equal(q, q0) and torch.equal(v, v0)
    assert float((v1 - v0).sum()) == float(td.sum()) > 0
    assert not torch.equal(q1, q0)
    assert mk.KERNEL.launches == gt.KERNEL.launches == 0


def test_learning_frame_unbiased():
    """Frame 2 samples a learned (non-uniform) table; its mean still
    matches the default megakernel's (tests/test_guided_mega_train.py:
    60-72)."""
    cfg = RenderConfig(width=48, height=48, samples_per_pixel=8,
                       max_ray_bounces=6)
    _, _, outs = _train(2, 2, cfg, 11)
    img2 = outs[-1][0]
    img_d, _ = mk.render_default_mega(99, cornell_box(), Camera.create(CAM),
                                      cfg, device="cpu", r_tile=512,
                                      pix_mux=2)
    assert torch.isfinite(img2).all()
    md = float(img_d.mean())
    assert abs(float(img2.mean()) - md) / md < 0.08


def test_q_learns_toward_radiance():
    """tests/test_guided_mega_train.py:75-87: Q stays above the threshold,
    moves away from its uniform start, and a good share of bins is
    visited; the visit invariant holds over three frames."""
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=8,
                       max_ray_bounces=8)
    q, v, outs = _train(2, 3, cfg, 5)
    qn = q[:G * G].numpy()
    assert np.isfinite(qn).all()
    assert (qn >= THR - 1e-6).all()
    assert float(np.std(qn)) > 0.01
    assert (v[:G * G].numpy() > 0).mean() > 0.05
    assert float(v.sum()) == sum(int(a["td_scatter_count"]) for _, a in outs)


def test_validation_errors():
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1,
                       max_ray_bounces=2)
    cam = Camera.create(CAM)
    q, v = gt.init_bin_q(T_PAD + 8, 2, G, 1.0)
    with pytest.raises(ValueError, match="t_pad"):
        gt.render_sarsa_mega_train(0, cornell_box(), cam,
                                   gt.rebuild_bin_cdf(q, G, 2, T_PAD + 8),
                                   q, v, cfg, THR, device="cpu")
    clutter = torch_scene(cornell_plus_clutter())
    t_pad = mk._t_pad(clutter.n_triangles)
    q, v = gt.init_bin_q(t_pad, 1, G, 1.0)
    with pytest.raises(ValueError, match="single-chunk"):
        gt.render_sarsa_mega_train(0, clutter, cam,
                                   gt.rebuild_bin_cdf(q, G, 1, t_pad), q, v,
                                   cfg, THR, device="cpu")
    q, v = gt.init_bin_q(T_PAD, 2, G, 1.0)
    with pytest.raises(ValueError, match="visits must be"):
        gt.render_sarsa_mega_train(0, cornell_box(), cam,
                                   gt.rebuild_bin_cdf(q, G, 2, T_PAD), q,
                                   v[:, :-1], cfg, THR, device="cpu")
