"""rlrpt_tpu_torch guided megakernel (B3's plain twin) and the binned-Q
host helpers vs rlrpt_tpu.

The CDF rebuild agrees to 1 bf16 ulp (torch's sum and scan round in
another order than XLA's); the guided twin draws the JAX kernel's
samples, so images agree per pixel up to paths where f32 rounding flips a
hit or a uv bin.  On the card (``-m chip``) the CUDA kernel and its two
``ablate`` builds give the twin's frame bit for bit, and a CUDA table
with a decreasing column is refused before any launch.
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
from _torch_parity import (assert_frame_parity, assert_same_frame,  # noqa: F401
                           card, card_scenes, cornell_plus_clutter,
                           kernel_seed, one_torch_thread, skewed_q,
                           torch_scene)

CAM = (0.0, 0.0, -3.0)
T_PAD = 40            # cornell: 38 triangles
SMALL = dict(width=64, height=64, samples_per_pixel=4, max_ray_bounces=10)
MAIN = dict(width=720, height=720, samples_per_pixel=32, max_ray_bounces=80)
# the card cases: (scene, uv_bins, sector grid, skew of the table's Q,
# RenderConfig keywords, r_tile, pix_mux, seed, ablate); "main_path" is
# the learning job's guided frame at the launcher's r_tile and pix_mux;
# "test_room_g12" the test room at the reference's own 12x12 sectors
CARD_CASES = {
    "initial": ("cornell", 4, 11, 0.0, SMALL, 128, 1, 777, "none"),
    "skewed": ("cornell", 4, 11, 3.0, SMALL, 128, 1, 777, "none"),
    "clutter_skewed": ("clutter", 4, 11, 3.0, SMALL, 128, 1, 777, "none"),
    "test_room_skewed": ("test_room", 4, 11, 3.0,
                         dict(SMALL, max_ray_bounces=80), 128, 1, 32, "none"),
    "torus_room_per_triangle": ("torus_room", 1, 11, 3.0, dict(
        SMALL, samples_per_pixel=2, max_ray_bounces=80), 128, 1, 42, "none"),
    "main_path": ("cornell", 4, 11, 0.0, MAIN, mk.R_TILE, mk.PIX_MUX, 6,
                  "none"),
    "test_room_g12": ("test_room", 4, 12, 3.0,
                      dict(SMALL, max_ray_bounces=80), 128, 1, 35, "none"),
    **{f"{m}_{size}": ("cornell", 4, 11, 0.0, kw, mk.R_TILE, mk.PIX_MUX, seed,
                       m)
       for m in ("uniform", "fetch")
       for size, kw, seed in (
           ("128", dict(width=128, height=128, samples_per_pixel=4,
                        max_ray_bounces=80), 31),
           ("main_path", MAIN, 6))},
}


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
        qt, vt = gt.init_bin_q(T_PAD, ub, g, 100.0 / g ** 2, device="cpu")
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(
            gt.bin_luminance(cornell_box(device="cpu"), T_PAD, ub).numpy(),
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
    # the sums take XLA's order (row_sum, row_cumsum): every bit equal
    np.testing.assert_array_equal(tt.cdf.view(torch.int16).numpy(),
                                  np.asarray(tj.cdf).view(np.int16))
    # the numpy hand-over of a bf16 table is exact
    tc = tri_bin_cdf_from_numpy(np.asarray(tj.cdf, np.float32),
                                sector_grid, 4, T_PAD)
    np.testing.assert_array_equal(tc.cdf.view(torch.int16).numpy(),
                                  np.asarray(tj.cdf).view(np.int16))


@pytest.mark.parametrize("sector_grid", [11, 12])
@pytest.mark.parametrize("mix", [0.0, 0.2])
def test_rebuild_bin_cdf_torch_order_within_one_ulp(sector_grid, mix):
    """jax_order=False, the card's default (torch.sum and torch.cumsum):
    every entry positive, so bf16 bit patterns order as the values; at
    most 1 ulp from JAX's table, on at most 1e-4 of the entries."""
    q = _q(4, sector_grid, skew=3.0, seed=sector_grid)
    tj = jgt.rebuild_bin_cdf(jnp.asarray(q), sector_grid, 4, T_PAD,
                             defensive_mix=mix)
    tt = gt.rebuild_bin_cdf(torch.from_numpy(q), sector_grid, 4, T_PAD,
                            defensive_mix=mix, jax_order=False)
    ulps = np.abs(tt.cdf.view(torch.int16).numpy().astype(np.int32)
                  - np.asarray(tj.cdf).view(np.int16).astype(np.int32))
    assert ulps.max() <= 1
    assert (ulps > 0).sum() <= 1e-4 * ulps.size, (ulps > 0).sum()


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
        kernel_seed(key), cornell_box(device="cpu"), Camera.create(CAM), tt,
        RenderConfig(**kw), device="cpu", r_tile=128, pix_mux=1)
    assert_frame_parity(img_t, aux_t, img_j, aux_j)


@pytest.mark.parametrize("ablate", ["uniform", "fetch"])
def test_ablated_twin_matches_jax(ablate):
    """render_guided_mega(ablate=...), the JAX kernel's perf-attribution
    switch: a uniform sector at the uniform pdf, "fetch" after reading the
    hit's bin column.  The frames are wrong by design, but the twin draws
    the JAX kernel's samples, so they agree per pixel as the guided frame
    does, at test_twin_matches_jax's point (the skewed uv4 table)."""
    q = _q(4, 11, 3.0)
    tj = jgt.rebuild_bin_cdf(jnp.asarray(q), 11, 4, T_PAD)
    tt = gt.rebuild_bin_cdf(torch.from_numpy(q), 11, 4, T_PAD)
    key = jax.random.PRNGKey(1)
    kw = dict(width=32, height=32, samples_per_pixel=4, max_ray_bounces=10)
    img_j, aux_j = jgm.render_guided_mega(
        key, jax_cornell_box(), JCamera.create(CAM), tj,
        jconfig.RenderConfig(**kw), r_tile=128, pix_mux=1, interpret=True,
        precision="highest", ablate=ablate)
    img_t, aux_t = gm.render_guided_mega(
        kernel_seed(key), cornell_box(device="cpu"), Camera.create(CAM), tt,
        RenderConfig(**kw), device="cpu", r_tile=128, pix_mux=1,
        ablate=ablate)
    assert_frame_parity(img_t, aux_t, img_j, aux_j)


def test_ablate_modes_checked():
    """An unknown mode raises ValueError (JAX takes it as "fetch"), in the
    launcher, the wrapper and the twin; "uniform" and "fetch" draw the
    same sectors, so their frames are equal, and differ from "none"."""
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=2,
                       max_ray_bounces=4)
    cam = Camera.create(CAM)
    table = gt.rebuild_bin_cdf(torch.from_numpy(_q(4, 11, 3.0)), 11, 4,
                               T_PAD)
    with pytest.raises(ValueError, match="ablate"):
        gm.render_guided_mega(0, cornell_box(device="cpu"), cam, table, cfg,
                              device="cpu", ablate="search")
    tris, mat = mk.pack_scene(cornell_box(device="cpu"))
    cdf_t = table.cdf.T.contiguous()
    args = (3, mk.camera_vector(cam), tris, mat, cdf_t, 11, 4, cfg, 256, 1)
    for fn in (gm.mega_guided_frame, gm.mega_guided_frame_plain):
        with pytest.raises(ValueError, match="ablate"):
            fn(*args, ablate="")
    out = {m: gm.mega_guided_frame(*args, ablate=m)
           for m in gm.ABLATE_MODES}
    for a, b in zip(out["uniform"], out["fetch"]):
        assert torch.equal(a, b)
    assert not torch.equal(out["none"][0], out["uniform"][0])


def _card_frame(card_scenes, name, uv_bins, grid, skew, kw, r_tile,
                pix_mux):
    """mega_guided_frame's arguments after the seed for a card case: the
    scene's tables and its skewed table, on the card."""
    scene = card_scenes[name]
    t_pad = mk._t_pad(scene.n_triangles)
    cfg = RenderConfig(**kw)
    table = gt.rebuild_bin_cdf(skewed_q(t_pad, uv_bins, skew, scene.v0.device,
                                        sector_grid=grid),
                               grid, uv_bins, t_pad)
    tris, mat = mk.pack_scene(scene)
    return (mk.camera_vector(Camera.create(CAM)), tris, mat,
            table.cdf.T.contiguous(), grid, uv_bins, cfg,
            mk.n_slots_for(cfg.n_pixels, r_tile, pix_mux), pix_mux)


@pytest.mark.chip
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_is_the_twin_on_the_card(card_scenes, case):
    *frame, seed, ablate = CARD_CASES[case]
    args = (seed, *_card_frame(card_scenes, *frame))
    kernel = gm._KERNELS[ablate]
    before = kernel.launches
    out = gm.mega_guided_frame(*args, ablate=ablate)
    assert kernel.launches == before + 1
    assert_same_frame(out, gm.mega_guided_frame_plain(*args, ablate=ablate))


@pytest.mark.chip
def test_a_decreasing_column_is_refused_on_the_card(card_scenes):
    """The binary search needs non-decreasing columns: check_cdf reads the
    CUDA table's order back and raises before any launch."""
    cam, tris, mat, cdf_t, *rest = _card_frame(card_scenes, "cornell", 4,
                                               11, 0.0, SMALL, 128, 1)
    cdf_t[17, 40] = cdf_t[17, 39] - 0.125
    before = gm.KERNEL.launches
    with pytest.raises(ValueError, match="decrease"):
        gm.mega_guided_frame(777, cam, tris, mat, cdf_t, *rest)
    assert gm.KERNEL.launches == before


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
    img_g, _ = gm.render_guided_mega(11, cornell_box(device="cpu"), cam, tb,
                                     cfg,
                                     device="cpu", r_tile=512, pix_mux=2)
    img_d, _ = mk.render_default_mega(13, cornell_box(device="cpu"), cam, cfg,
                                      device="cpu", r_tile=512, pix_mux=2)
    assert torch.isfinite(img_g).all()
    mg, md = float(img_g.mean()), float(img_d.mean())
    assert abs(mg - md) / md < 0.08, (mg, md)


def test_validation_errors():
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1,
                       max_ray_bounces=2)
    cam = Camera.create(CAM)
    q, _ = gt.init_bin_q(T_PAD + 8, 2, 11, 1.0, device="cpu")
    with pytest.raises(ValueError, match="t_pad"):
        gm.render_guided_mega(0, cornell_box(device="cpu"), cam,
                              gt.rebuild_bin_cdf(q, 11, 2, T_PAD + 8), cfg,
                              device="cpu")
    clutter = torch_scene(cornell_plus_clutter())
    t_pad = mk._t_pad(clutter.n_triangles)
    q, _ = gt.init_bin_q(t_pad, 4, 11, 1.0, device="cpu")
    with pytest.raises(ValueError, match="uv_bins=1"):
        gm.render_guided_mega(0, clutter, cam,
                              gt.rebuild_bin_cdf(q, 11, 4, t_pad), cfg,
                              device="cpu")
    # per-triangle tables do run on multi-chunk scenes
    q, _ = gt.init_bin_q(t_pad, 1, 11, 1.0, device="cpu")
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


@pytest.mark.parametrize("rows", [9, 33, 121, 144, 300])
def test_row_sum_and_cumsum_take_jax_order(rows):
    """row_sum and row_cumsum over sector rows of skewed non-negative
    weights equal jnp.sum and jnp.cumsum over axis 0 bit for bit (one,
    two and three levels of XLA's windows and blocks), where torch.sum
    and torch.cumsum round some entries otherwise."""
    w = (np.random.default_rng(rows).uniform(0, 1, (rows, 640)) ** 6
         ).astype(np.float32)
    t = torch.from_numpy(w)
    np.testing.assert_array_equal(
        gt.row_sum(t).numpy(), np.asarray(jnp.sum(jnp.asarray(w), axis=0)))
    np.testing.assert_array_equal(
        gt.row_cumsum(t).numpy(), np.asarray(jnp.cumsum(jnp.asarray(w),
                                                        axis=0)))
