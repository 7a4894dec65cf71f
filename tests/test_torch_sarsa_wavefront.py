"""rlrpt_tpu_torch's fine-map SARSA tracers (the regenerative wavefront on
kernel B4a's twin, the lockstep tracer on B4b's), Voronoi and precompute
against rlrpt_tpu's on the CPU.

The XLA paths draw from threefry and the port from a torch.Generator, so
frames are held statistically with the JAX test's own tolerance
(tests/test_sarsa_wavefront.py:46-48): the port's frame is within 3x the
JAX-vs-JAX noise + 1e-3 of JAX's (mean absolute pixel difference), avg
path within 5%.  Compaction, flush, the visit invariant and the search
answers are exact.  Sizes are the JAX tests': 24x24, 8 spp, 12 bounces,
one volume per 0.05 of area (V = 480).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.camera import primary_rays as j_primary_rays
from rlrpt_tpu.config import RadianceVolumeConfig as JRL
from rlrpt_tpu.config import RenderConfig as JCfg
from rlrpt_tpu.integrators import sarsa_wavefront as jsw
from rlrpt_tpu.integrators.precompute import precompute_radiance_grids as jpre
from rlrpt_tpu.integrators.reinforcement_tracer import render_frame_sarsa as jlock
from rlrpt_tpu.ops.intersect import closest_hit as j_closest_hit
from rlrpt_tpu.radiance.grid_bucket import build_volume_class_table as jtable
from rlrpt_tpu.radiance.nn_search import find_closest_volume as j_closest_vol
from rlrpt_tpu.radiance.volumes import build_radiance_volumes as jbuild
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.integrators import precompute, sarsa_wavefront as sw
from rlrpt_tpu_torch.integrators.reinforcement_tracer import render_frame_sarsa
from rlrpt_tpu_torch.integrators.voronoi import (render_voronoi,
                                                 voronoi_colours, voronoi_ids)
from rlrpt_tpu_torch.ops import intersect_pallas as ip
from rlrpt_tpu_torch.radiance.grid_bucket import (build_volume_class_table,
                                                  build_volume_grid)
from rlrpt_tpu_torch.radiance.volumes import build_radiance_volumes
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.tools import sarsa_fast_profile as sfp
from _torch_parity import one_torch_thread, torch_scene  # noqa: F401

KW = dict(width=24, height=24, samples_per_pixel=8, max_ray_bounces=12,
          ray_tile=1024)
CAM = (0.0, 0.0, -3.0)
A = np.asarray


@pytest.fixture(scope="module")
def jax_frames():
    """Two JAX wavefront frames (keys 3, 4; the class table, hit_mode
    "f32") and two lockstep frames, with their JAX-vs-JAX noise."""
    js = jax_cornell_box()
    rl = JRL(area_per_sample=0.05)
    jv = jbuild(js, rl)
    tb = jtable(jv, js)
    cam, cfg = JCamera.create(CAM), JCfg(**KW)
    wf = [jsw.render_frame_sarsa_wavefront(
        jax.random.PRNGKey(k), js, cam, jv, tb, cfg, rl, interpret=True,
        hit_mode="f32") for k in (3, 4)]
    lk = [jlock(jax.random.PRNGKey(k), js, cam, jv, cfg, rl) for k in (3, 4)]
    return wf, lk


@pytest.fixture(scope="module")
def port_setup():
    scene = cornell_box(device="cpu")
    rl = RadianceVolumeConfig(area_per_sample=0.05)
    vols = build_radiance_volumes(scene, rl)
    return scene, rl, vols, build_volume_class_table(vols, scene)


def _close_to_jax(img, aux, frames):
    (ij1, _, aj1), (ij2, _, _) = frames
    noise = float(np.mean(np.abs(A(ij1) - A(ij2))))
    err = float(np.mean(np.abs(img.numpy() - A(ij1))))
    assert np.isfinite(img.numpy()).all()
    assert err < 3.0 * noise + 1e-3, (err, noise)
    at, aj = float(aux["avg_path_length"]), float(aj1["avg_path_length"])
    assert abs(at - aj) <= 0.05 * aj, (at, aj)


@pytest.mark.parametrize("min_drain_w", [512, 16], ids=["one_phase",
                                                          "cascade"])
def test_wavefront_frame_matches_jax(jax_frames, port_setup, min_drain_w):
    """One sarsa-fast frame (B4a's twin with the table's class ids, pix_mux
    1) against JAX's, with and without a drain cascade; the visit delta
    equals the TD scatter count exactly."""
    scene, rl, vols, tb = port_setup
    img, out, aux = sw.render_frame_sarsa_wavefront(
        3, scene, Camera.create(CAM), vols, tb, RenderConfig(**KW), rl,
        min_drain_w=min_drain_w)
    _close_to_jax(img, aux, jax_frames[0])
    widths = aux["phase_widths"]
    assert widths == ((576,) if min_drain_w == 512 else (576, 144, 36))
    assert (aux["phase_iterations"] > 0).all()
    assert int(aux["wavefront_iterations"]) == int(
        aux["phase_iterations"].sum())
    td = int(aux["td_scatter_count"])
    assert td > 0 and int((out.visits - vols.visits).sum()) == td
    assert not torch.equal(out.q, vols.q) and torch.equal(
        vols.visits, torch.zeros_like(vols.visits))      # input untouched


def test_lockstep_frame_matches_jax(jax_frames, port_setup):
    scene, rl, vols, _ = port_setup
    img, out, aux = render_frame_sarsa(3, scene, Camera.create(CAM), vols,
                                       RenderConfig(**KW), rl)
    _close_to_jax(img, aux, jax_frames[1])
    td = int(aux["td_scatter_count"])
    assert td > 0 and int(out.visits.sum()) == td


def test_learning_health_over_frames(port_setup):
    """Three sarsa-fast frames (pix_mux 4): zclp does not rise, the image
    stays finite, the visit invariant holds across frames."""
    scene, rl, vols, tb = port_setup
    cam, cfg = Camera.create(CAM), RenderConfig(**KW)
    zclps, td = [], 0
    for f in range(3):
        img, vols, aux = sw.render_frame_sarsa_wavefront(
            10 + f, scene, cam, vols, tb, cfg, rl, pix_mux=4)
        zclps.append(int(aux["zero_contribution_light_paths"]))
        td += int(aux["td_scatter_count"])
    assert zclps[-1] <= zclps[0], zclps
    assert torch.isfinite(img).all() and int(vols.visits.sum()) == td


def test_options_and_hit_modes(port_setup):
    """hit_mode "f32" (B4b's twin, gathers) and "mxu" (B4a's twin) are
    both exact f32: one generator state gives one frame.  The bucket grid,
    the two-level sampler, the volume frame and bf16 rows give finite
    frames with the visit invariant; bad options raise."""
    scene, rl, vols, tb = port_setup
    cam, cfg = Camera.create(CAM), RenderConfig(**KW)
    before = (ip.KERNEL_F32.launches, ip.KERNEL_MAT.launches)
    a = sw.render_frame_sarsa_wavefront(5, scene, cam, vols, tb, cfg, rl,
                                        hit_mode="mxu")
    b = sw.render_frame_sarsa_wavefront(5, scene, cam, vols, tb, cfg, rl,
                                        hit_mode="f32")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1].q, b[1].q)
    grid = build_volume_grid(vols)
    for kw in (dict(sampler="hier", frame_mode="volume"),
               dict(cdf_dtype="bf16", pix_mux=2)):
        img, out, aux = sw.render_frame_sarsa_wavefront(
            6, scene, cam, vols, grid, cfg, rl, **kw)
        assert torch.isfinite(img).all() and float(img.mean()) > 0
        assert int(out.visits.sum()) == int(aux["td_scatter_count"]) > 0
    assert (ip.KERNEL_F32.launches, ip.KERNEL_MAT.launches) == before
    for bad in (dict(hit_mode="bf16"), dict(sampler="x"),
                dict(frame_mode="x"), dict(cdf_dtype="f16")):
        with pytest.raises(ValueError):
            sw.render_frame_sarsa_wavefront(5, scene, cam, vols, tb, cfg, rl,
                                            **bad)


def test_profile_probe_variants(port_setup):
    """Every variant the sarsa_fast_profile probe compares runs, with the
    visit invariant exact at each live-count read interval (a late read
    only adds idle iterations); its device-busy union merges overlaps."""
    scene, rl, vols, tb = port_setup
    cam, cfg = Camera.create(CAM), RenderConfig(**KW)
    default = sw.SYNC_EVERY
    for _, se, kw in sfp.VARIANTS:
        sw.SYNC_EVERY = se or default
        try:
            img, out, aux = sw.render_frame_sarsa_wavefront(
                7, scene, cam, vols, tb, cfg, rl, **kw)
        finally:
            sw.SYNC_EVERY = default
        assert torch.isfinite(img).all() and float(img.mean()) > 0
        assert (int(out.visits.sum()) - int(vols.visits.sum())
                == int(aux["td_scatter_count"]) > 0)
    assert sfp.busy_us([(5, 7), (0, 2), (1, 3), (7, 8)]) == 6
    assert sfp.rotated([1, 2, 3], 4) == [2, 3, 1]


def test_mat_row_normal_is_the_scene_normal():
    """B4a's material row carries the exact f32 triangle normal, so the
    grid search's exact-normal filter reads it directly (no re-gather as
    on the TPU's bf16 hi/lo rows)."""
    scene = cornell_box(device="cpu")
    tris, mat = ip.pack_scene_mxu(scene, torch.arange(scene.n_triangles))
    assert torch.equal(mat[:, 0:3], scene.normal)
    assert torch.equal(mat[:, 11], torch.arange(scene.n_triangles).float())


def _random_state(rng, w, mux, n_live):
    """JAX and port slot states from the same numpy arrays."""
    act = np.zeros(w, bool)
    act[rng.choice(w, n_live, replace=False)] = True
    f = {"o": rng.random((w, 3)), "d": rng.random((w, 3)),
         "tp": rng.random((w, 3)), "pixel": rng.integers(0, 999, w),
         "kmx": rng.integers(0, mux, w), "bounce": rng.integers(0, 9, w),
         "remaining": rng.integers(0, 4, w), "active": act,
         "sample_rad": rng.random((w, 3)),
         "slot_rad": rng.random((w, mux, 3)),
         "cur_vol": rng.integers(0, 480, w),
         "cur_sector": rng.integers(-1, 144, w),
         "cur_brdf": rng.random(w)}
    f = {k: (v.astype(np.float32) if v.dtype == np.float64 else
             v.astype(np.int32) if v.dtype == np.int64 else v)
         for k, v in f.items()}
    return f


def test_compact_and_flush_equal_jax():
    """_compact on the same state arrays gives JAX's permutation exactly;
    _flush adds the banked rows where the JAX flush (a closure of
    trace_frame_sarsa_wavefront, sarsa_wavefront.py:444-454, restated
    here) does, dropping ids past the image."""
    rng = np.random.default_rng(0)
    w, mux, n_pix, w0 = 300, 3, 700, 320
    f = _random_state(rng, w, mux, 117)
    jstate = jsw._State(**{k: jnp.asarray(v) for k, v in f.items()},
                        image=None, cdfplus=None, path_sum=None, zclp=None,
                        iters=None, td_count=None, vols=None)
    tstate = sw._State(**{k: torch.from_numpy(v) for k, v in f.items()})
    jc = jsw._compact(jstate, w)
    tc = sw._compact(tstate, w)
    for k in sw._SLOT_FIELDS:
        assert np.array_equal(getattr(tc, k).numpy(), A(getattr(jc, k))), k
    assert tc.active[:117].all() and not tc.active[117:].any()

    image0 = rng.random((n_pix, 3)).astype(np.float32)
    kmx = rng.integers(0, mux, w)
    pixel = rng.permutation(w0)[:w] + kmx * w0      # one slot per s0
    idx = (pixel - kmx * w0)[:, None] + np.arange(mux)[None, :] * w0
    valid = (idx >= 0) & (idx < n_pix)
    assert 0 < valid.mean() < 1
    flat = np.where(valid, idx, n_pix).reshape(-1)
    data = np.where(valid[..., None], f["slot_rad"], 0.0).reshape(-1, 3)
    ref = A(jnp.asarray(image0).at[jnp.asarray(flat)].add(
        jnp.asarray(data, jnp.float32), mode="drop"))
    out = sw._flush(torch.from_numpy(image0.copy()), torch.from_numpy(pixel),
                    torch.from_numpy(kmx), torch.from_numpy(f["slot_rad"]),
                    w0)
    assert np.array_equal(out.numpy(), ref)


def test_voronoi_ids_equal_jax(port_setup):
    """The same camera rays give JAX's volume ids (surface hits)."""
    js = jax_cornell_box()
    jv = jbuild(js, JRL(area_per_sample=0.05))
    o, d = j_primary_rays(jax.random.PRNGKey(2), JCamera.create(CAM), 40, 40,
                          40.0)
    h = j_closest_hit(o, d, js)
    ij = A(j_closest_vol(jv, h.position, h.normal))
    scene, _, vols, _ = port_setup
    it, surf = voronoi_ids(torch.tensor(A(o)), torch.tensor(A(d)),
                           scene, vols)
    hit = A(h.hit_type) == 2
    assert np.array_equal(surf.numpy(), hit)
    assert (it.numpy()[hit] == ij[hit]).mean() >= 0.999
    g = torch.Generator().manual_seed(1)
    img = render_voronoi(g, scene, Camera.create(CAM), vols,
                         voronoi_colours(g, vols.n_volumes),
                         RenderConfig(width=16, height=16))
    assert img.shape == (16, 16, 3) and (img <= 1).all() and (img >= 0).all()


def test_precompute_matches_jax():
    """precompute_radiance_grids: mean q within 5% of JAX's (grid 6, 4
    paths per sector, 4 bounces); the importance-sampled and irradiance
    renders of the map are finite and lit."""
    kw = dict(width=24, height=24, samples_per_pixel=2, max_ray_bounces=4,
              ray_tile=1024)
    js = jax_cornell_box()
    jv = jpre(jax.random.PRNGKey(0), js,
              jbuild(js, JRL(area_per_sample=0.05, grid_resolution=6)),
              JCfg(**kw), spp=4)
    scene = torch_scene(js)
    rl = RadianceVolumeConfig(area_per_sample=0.05, grid_resolution=6)
    g = torch.Generator().manual_seed(0)
    tvols = precompute.precompute_radiance_grids(
        g, scene, build_radiance_volumes(scene, rl), RenderConfig(**kw),
        spp=4)
    mq, mj = float(tvols.q.mean()), float(jnp.mean(jv.q))
    assert abs(mq - mj) <= 0.05 * mj, (mq, mj)
    assert torch.isfinite(tvols.q).all() and float(tvols.q.std()) > 0
    cam = Camera.create(CAM)
    img = precompute.render_precomputed_irradiance(g, scene, cam, tvols,
                                                   RenderConfig(**kw))
    img2, _ = precompute.render_importance_sampled(g, scene, cam, tvols,
                                                   RenderConfig(**kw), rl)
    for im in (img, img2):
        assert im.shape == (24, 24, 3) and torch.isfinite(im).all()
        assert float(im.max()) > 0
