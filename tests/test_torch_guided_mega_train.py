"""rlrpt_tpu_torch learning frame (B2's plain twin) vs rlrpt_tpu.

The JAX kernel runs in interpret mode at precision="highest" with one ray
tile covering every slot (r_tile 512 >= n_slots), which is the port's
one-batch-per-iteration schedule.  Both sides get the same table each
frame (the JAX rebuild, handed over with tri_bin_cdf_from_numpy) and carry
their own q and visits.  On the card (``-m chip``) the CUDA kernel, and its
timed build, give the twin's frame and visits bit for bit, and B3's frame
for the same seed and table; q within rtol 1e-4 of the twin's (the
kernel's atomics add the TD targets and the irradiance in another order).
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
from rlrpt_tpu_torch.utils import profiling
from _torch_parity import (assert_frame_parity, assert_same_frame,  # noqa: F401
                           card, card_scenes, cornell_plus_clutter,
                           kernel_seed, one_torch_thread, skewed_q,
                           torch_scene)

CAM = (0.0, 0.0, -3.0)
T_PAD = 40            # cornell: 38 triangles
G = 11
THR = RadianceVolumeConfig(grid_resolution=G).radiance_threshold
INIT = RadianceVolumeConfig(grid_resolution=G).initial_radiance
SMALL = dict(width=64, height=64, samples_per_pixel=4, max_ray_bounces=10)
MAIN = dict(width=720, height=720, samples_per_pixel=32, max_ray_bounces=80)
# the card cases: (scene, sector grid, skew of Q, RenderConfig keywords,
# pix_mux, seed, numpy seed of the visits in, or None for zeros);
# "main_path" is the learning job's frame from the initial Q at the
# launcher's pix_mux, "test_room_g12*" the test room at the reference's
# own 12x12 sectors (144 sectors: B2's apply deals 12 column groups x 18
# chunks, B3's search takes 8 probes)
CARD_CASES = {
    **{f"{q}_rr_{rr}": ("cornell", G, skew,
                        dict(SMALL, russian_roulette=on), 1, 888, 5)
       for q, skew in (("initial", 0.0), ("skewed", 3.0))
       for rr, on in (("off", False), ("on", True))},
    "test_room_skewed": ("test_room", G, 3.0, dict(SMALL, max_ray_bounces=80),
                         1, 33, 18),
    "main_path": ("cornell", G, 0.0, MAIN, mk.PIX_MUX, 6, None),
    "test_room_g12": ("test_room", 12, 3.0, dict(SMALL, max_ray_bounces=80),
                      1, 34, 19),
    "test_room_g12_main_path": ("test_room", 12, 0.0, MAIN, mk.PIX_MUX, 7,
                                None),
}


def _train(uv_bins: int, n_frames: int, cfg: RenderConfig, seed0: int,
           pix_mux: int = 2, r_tile: int = 512):
    """Twin frames from the initial Q; returns (q, visits, per-frame
    (image, aux))."""
    q, v = gt.init_bin_q(T_PAD, uv_bins, G, INIT, device="cpu")
    outs = []
    for f in range(n_frames):
        tb = gt.rebuild_bin_cdf(q, G, uv_bins, T_PAD)
        img, q, v, aux = gt.render_sarsa_mega_train(
            seed0 + f, cornell_box(device="cpu"), Camera.create(CAM), tb, q,
            v, cfg, THR,
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
            kernel_seed(key), cornell_box(device="cpu"), Camera.create(CAM),
            tt, qt, vt,
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


def test_table_keywords_default_to_the_table():
    """sector_grid and uv_bins passed as the table's own values give the
    default call's frame, q and visits (guided_mega_train.py:474-475);
    any other value raises ValueError, since the table carries them."""
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=2,
                       max_ray_bounces=4)
    q, v = gt.init_bin_q(T_PAD, 2, G, INIT, device="cpu")
    tb = gt.rebuild_bin_cdf(q, G, 2, T_PAD)
    outs = [gt.render_sarsa_mega_train(
        5, cornell_box(device="cpu"), Camera.create(CAM), tb, q, v, cfg,
        THR, device="cpu", r_tile=256, pix_mux=1, **kw)
        for kw in ({}, {"sector_grid": G, "uv_bins": 2})]
    (img_a, q_a, v_a, aux_a), (img_b, q_b, v_b, aux_b) = outs
    for a, b in ((img_a, img_b), (q_a, q_b), (v_a, v_b)):
        assert torch.equal(a, b)
    assert int(aux_a["td_scatter_count"]) == int(aux_b["td_scatter_count"])
    assert int(aux_a["td_scatter_count"]) > 0
    for kw in ({"sector_grid": G - 1}, {"uv_bins": 4}):
        with pytest.raises(ValueError, match="differs from the table"):
            gt.render_sarsa_mega_train(
                5, cornell_box(device="cpu"), Camera.create(CAM), tb, q, v,
                cfg, THR, device="cpu", r_tile=256, pix_mux=1, **kw)


def test_image_is_the_guided_frame_and_inputs_untouched():
    """The paths never read Q: a learning frame's rad, path_sum and iters
    are the guided twin's bit for bit; q and visits come back new."""
    cfg = RenderConfig(width=24, height=24, samples_per_pixel=4,
                       max_ray_bounces=8, russian_roulette=True)
    rng = np.random.default_rng(4)
    q, v = gt.init_bin_q(T_PAD, 2, G, INIT, device="cpu")
    q = q * torch.from_numpy(np.exp(rng.random(q.shape)).astype(np.float32))
    v = torch.from_numpy(rng.integers(0, 5, v.shape).astype(np.float32))
    q0, v0 = q.clone(), v.clone()
    tb = gt.rebuild_bin_cdf(q, G, 2, T_PAD)
    cdf_t = tb.cdf.T.contiguous()
    cam = mk.camera_vector(Camera.create(CAM))
    scene = cornell_box(device="cpu")
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


@pytest.mark.chip
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_is_the_twin_on_the_card(card_scenes, case):
    name, grid, skew, kw, pix_mux, seed, v_seed = CARD_CASES[case]
    scene = card_scenes[name]
    dev = scene.v0.device
    t_pad = mk._t_pad(scene.n_triangles)
    cfg = RenderConfig(**kw)
    n_slots = mk.n_slots_for(cfg.n_pixels, mk.R_TILE, pix_mux)
    q_in = skewed_q(t_pad, 4, skew, dev, sector_grid=grid)
    v_in = torch.zeros_like(q_in) if v_seed is None else torch.from_numpy(
        np.random.default_rng(v_seed).integers(0, 3, q_in.shape).astype(
            np.float32)).to(dev)
    cdf_t = gt.rebuild_bin_cdf(q_in, grid, 4, t_pad).cdf.T.contiguous()
    cam = mk.camera_vector(Camera.create(CAM))
    tris, mat = mk.pack_scene(scene)
    thr = RadianceVolumeConfig(grid_resolution=grid).radiance_threshold
    args = (seed, cam, tris, mat, cdf_t,
            gt.bin_luminance(scene, t_pad, 4)[0].contiguous(),
            hs.sector_cos_thetas(grid, dev).contiguous(), q_in, v_in, grid, 4,
            thr, cfg, n_slots, pix_mux)
    before = gt.KERNEL.launches
    out = gt.mega_train_frame(*args)
    assert gt.KERNEL.launches == before + 1
    clock = torch.zeros((gt.train_blocks(n_slots, dev),
                         len(profiling.CLOCK_COLS)), dtype=torch.int64,
                        device=dev)
    before = gt.KERNEL_TIMED.launches
    timed = gt.mega_train_frame(*args, clock=clock)
    assert gt.KERNEL_TIMED.launches == before + 1
    assert int(clock[:, profiling.CLOCK_COLS.index("total")].sum()) > 0
    twin = gt.mega_train_frame_plain(*args)
    guided = gm.mega_guided_frame(seed, cam, tris, mat, cdf_t, grid, 4, cfg,
                                  n_slots, pix_mux)
    for frame in (timed, twin):
        assert_same_frame(out[:3], frame[:3])
        assert torch.equal(out[4], frame[4])
    assert_same_frame(out[:3], guided)
    for q, v, td in (out[3:], twin[3:]):
        assert torch.isfinite(q).all() and not torch.equal(q, q_in)
        assert float((v - v_in).double().sum()) == float(td.double().sum())
        assert float(td.double().sum()) > 0
    for q in (out[3], timed[3]):
        rel = ((q - twin[3]).abs() / twin[3].abs().clamp(min=1e-30)).max()
        assert float(rel) <= 1e-4


def test_learning_frame_unbiased():
    """Frame 2 samples a learned (non-uniform) table; its mean still
    matches the default megakernel's (tests/test_guided_mega_train.py:
    60-72)."""
    cfg = RenderConfig(width=48, height=48, samples_per_pixel=8,
                       max_ray_bounces=6)
    _, _, outs = _train(2, 2, cfg, 11)
    img2 = outs[-1][0]
    img_d, _ = mk.render_default_mega(99, cornell_box(device="cpu"),
                                      Camera.create(CAM),
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
    q, v = gt.init_bin_q(T_PAD + 8, 2, G, 1.0, device="cpu")
    with pytest.raises(ValueError, match="t_pad"):
        gt.render_sarsa_mega_train(0, cornell_box(device="cpu"), cam,
                                   gt.rebuild_bin_cdf(q, G, 2, T_PAD + 8),
                                   q, v, cfg, THR, device="cpu")
    clutter = torch_scene(cornell_plus_clutter())
    t_pad = mk._t_pad(clutter.n_triangles)
    q, v = gt.init_bin_q(t_pad, 1, G, 1.0, device="cpu")
    with pytest.raises(ValueError, match="single-chunk"):
        gt.render_sarsa_mega_train(0, clutter, cam,
                                   gt.rebuild_bin_cdf(q, G, 1, t_pad), q, v,
                                   cfg, THR, device="cpu")
    q, v = gt.init_bin_q(T_PAD, 2, G, 1.0, device="cpu")
    with pytest.raises(ValueError, match="visits must be"):
        gt.render_sarsa_mega_train(0, cornell_box(device="cpu"), cam,
                                   gt.rebuild_bin_cdf(q, G, 2, T_PAD), q,
                                   v[:, :-1], cfg, THR, device="cpu")
