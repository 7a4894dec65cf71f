"""rlrpt_tpu_torch default megakernel (B1's plain twin) vs the JAX
megakernel in interpret mode, per pixel, and vs the port's plain default
tracer, statistically.

The twin draws the JAX kernel's samples (same int seed, counter hash,
n_slots and pix_mux), so images agree per pixel up to paths where f32
rounding flips a hit.  On the card (``-m chip``) the CUDA kernel gives the
twin's frame bit for bit (both round every f32 operation alike: the
kernels build with -fmad=false).
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
from _torch_parity import (assert_frame_parity, assert_same_frame,  # noqa: F401
                           card, card_scenes, cornell_plus_clutter,
                           kernel_seed, one_torch_thread, torch_scene)

CAM = (0.0, 0.0, -3.0)
SMALL = dict(width=64, height=64, samples_per_pixel=4, max_ray_bounces=10)
# the card cases: (scene, RenderConfig keywords, r_tile, pix_mux, seed);
# "main_path" is the bench point at the launcher's r_tile and pix_mux
CARD_CASES = {
    "cornell_rr_off": ("cornell", SMALL, 128, 4, 20240),
    "cornell_rr_on": ("cornell", dict(SMALL, russian_roulette=True), 128, 4,
                      20240),
    "clutter": ("clutter", SMALL, 128, 4, 20240),
    "test_room": ("test_room", dict(SMALL, max_ray_bounces=80), 128, 1, 31),
    "torus_room": ("torus_room", dict(SMALL, samples_per_pixel=2,
                                      max_ray_bounces=80), 128, 1, 41),
    "torus_room_morton": ("torus_room_morton", dict(
        SMALL, samples_per_pixel=2, max_ray_bounces=80), 128, 1, 41),
    "main_path": ("cornell", dict(width=720, height=720, samples_per_pixel=1,
                                  max_ray_bounces=80), mk.R_TILE,
                  mk.PIX_MUX, 5),
}


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
    """288 triangles pad to 512: the JAX launcher streams two chunks with
    its AABB cull, and the port walks the frame's BVH (both launchers'
    default there; tests/test_torch_mega_cull.py holds the walk to the
    sweep bit for bit)."""
    scene = cornell_plus_clutter()
    assert jmk._t_pad(scene.n_triangles) == 2 * jmk.T_CHUNK
    (img_t, aux_t), (img_j, aux_j) = _both(
        scene, jax.random.PRNGKey(1), 128, 4, width=24, height=24,
        samples_per_pixel=4, max_ray_bounces=8)
    assert_frame_parity(img_t, aux_t, img_j, aux_j)


@pytest.mark.chip
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_is_the_twin_on_the_card(card_scenes, case):
    name, kw, r_tile, pix_mux, seed = CARD_CASES[case]
    cfg = RenderConfig(**kw)
    tris, mat = mk.pack_scene(card_scenes[name])
    args = (seed, mk.camera_vector(Camera.create(CAM)), tris, mat, cfg,
            mk.n_slots_for(cfg.n_pixels, r_tile, pix_mux), pix_mux)
    before = mk.KERNEL.launches
    out = mk.mega_default_frame(*args)
    assert mk.KERNEL.launches == before + 1
    assert_same_frame(out, mk.mega_default_frame_plain(*args))


@pytest.mark.parametrize("n", [1, 8, 38, 255, 256, 257, 600])
def test_t_pad_matches_jax(n):
    assert mk._t_pad(n) == jmk._t_pad(n)


@pytest.fixture(scope="module")
def renders():
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=8,
                       max_ray_bounces=10)
    cam = Camera.create(CAM)
    img_m, aux_m = mk.render_default_mega(11, cornell_box(device="cpu"), cam,
                                          cfg,
                                          device="cpu", r_tile=128,
                                          pix_mux=4)
    img_d, aux_d = render_default(7, cornell_box(device="cpu"), cam, cfg,
                                  device="cpu")
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
    tris, mat = mk.pack_scene(cornell_box(device="cpu"))
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
    tris, mat = mk.pack_scene(cornell_box(device="cpu"))
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
    tris, mat = mk.pack_scene(cornell_box(device="cpu"))
    n_slots = mk.n_slots_for(cfg.n_pixels, 128, 1)
    _, path_sum, iters = mk.mega_default_frame(
        9, mk.camera_vector(Camera.create(CAM)), tris, mat, cfg, n_slots, 1)
    # pix_mux 1, 1 spp: a slot is active for exactly its path's segments
    assert int(iters.sum()) == int(path_sum.sum())
    warp, block = lane_efficiency(iters, 32), lane_efficiency(iters, 128)
    assert 0.0 < block <= warp <= 1.0


def test_flipped_pixel_is_jax_expanded_hit(monkeypatch):
    """At tests/test_megakernel.py's cull point (Cornell, PRNGKey 9, 32x32,
    4 spp, 6 bounces, r_tile 256, pix_mux 2) the twin and JAX's interpret
    kernel at precision "highest" differ in one pixel, 570: slot 58's
    second pixel.  Recording the interpret kernel's per-step hit matmul
    for slot 58 (jax.lax.dot_general wrapped here, rlrpt_tpu untouched)
    and hitting each recorded ray with the twin's own Moller-Trumbore
    (closest_hit_mt) and a float64 one: the two packages agree on every
    step (the same triangle, t within 1e-5 relative) up to the first
    step of pixel 570 where a ray leaves a wall 2e-5 from another one.
    There JAX's expanded o_i d_j form (t' = o.(e1 x e2) - v0.(e1 x e2),
    megakernel.py:85-134) cancels: its t is more than 10% from float64's,
    while the twin's is within 1e-5 of it; the paths part there."""
    (img_t, _), (img_j, _) = _both(
        jax_cornell_box(), jax.random.PRNGKey(9), 256, 2, width=32,
        height=32, samples_per_pixel=4, max_ray_bounces=6)
    diff = np.abs(img_t.numpy() - np.asarray(img_j)).max(-1).reshape(-1)
    assert np.nonzero(diff > 1e-3)[0].tolist() == [570]

    calls, lane = [], 58
    dot_general = jax.lax.dot_general

    def recorded(lhs, rhs, *a, **k):
        out = dot_general(lhs, rhs, *a, **k)
        if lhs.shape[-1] == 16 and rhs.shape == (16, 256):   # the MT sweep
            jax.debug.callback(lambda o, f, q: calls.append(
                (np.array(o), np.array(f), np.array(q))), rhs[0:3],
                rhs[:, lane], out[:, lane])
        return out

    jax.clear_caches()
    monkeypatch.setattr(jax.lax, "dot_general", recorded)
    jmk.render_default_mega(
        jax.random.PRNGKey(9), jax_cornell_box(), JCamera.create(CAM),
        jconfig.RenderConfig(width=32, height=32, samples_per_pixel=4,
                             max_ray_bounces=6),
        r_tile=256, pix_mux=2, interpret=True, precision="highest")
    monkeypatch.undo()
    jax.clear_caches()
    # tile 0 runs first; tile 1 starts with every lane at the camera
    cam = np.array(CAM, np.float32)
    tile0 = next(i for i in range(1, len(calls))
                 if np.all(calls[i][0] == cam[:, None]))

    scene = cornell_box(device="cpu")
    tris, _ = mk.pack_scene(scene)
    v0 = scene.v0.double().numpy()
    e1, e2 = (scene.v1.double().numpy() - v0, scene.v2.double().numpy() - v0)
    samples = 0
    for step in range(tile0):
        _, f, q = calls[step]
        o, d = f[0:3], f[3:6]
        samples += bool(np.array_equal(o, cam))
        # JAX's hit from its recorded [det | u' | v' | t'] rows
        det, up, vp, tq = q.reshape(4, -1)
        with np.errstate(divide="ignore", invalid="ignore"):
            valid = ((up * det >= 0) & (vp * det >= 0)
                     & (up * det + vp * det <= det * det) & (tq * det > 0))
            j_t = np.where(valid, tq / det, np.inf)
        # the twin's, and float64 Moller-Trumbore's
        t_t, t_i, *_ = mk.closest_hit_mt(*(torch.tensor([x]) for x in
                                           (*o, *d)), tris)
        p = np.cross(d.astype(np.float64), e2)
        det64 = (e1 * p).sum(-1)
        s = o.astype(np.float64) - v0
        qv = np.cross(s, e1)
        with np.errstate(divide="ignore", invalid="ignore"):
            u, v = (s * p).sum(-1) / det64, (d * qv).sum(-1) / det64
            t64 = np.where((det64 != 0) & (u >= 0) & (v >= 0) & (u + v <= 1),
                           (e2 * qv).sum(-1) / det64, np.inf)
        t64 = np.where(t64 > 0, t64, np.inf)
        if np.isinf(j_t.min()):
            assert float(t_t[0]) >= mk.INF and np.isinf(t64.min())
            continue
        hit = int(np.argmin(j_t))
        assert int(t_i[0]) == hit == int(np.argmin(t64)), step
        rel = abs(float(t_t[0]) - j_t[hit]) / j_t[hit]
        assert abs(float(t_t[0]) - t64[hit]) <= 1e-5 * t64[hit], step
        if rel > 1e-5:
            break
    assert samples == 5 and 5e-6 < t64[hit] < 1e-4     # pixel 570's first
    assert abs(j_t[hit] - t64[hit]) > 0.1 * t64[hit], (j_t[hit], t64[hit])
