"""rlrpt_tpu_torch closest-hit launchers (the plain twin of kernels B4a-c)
vs the JAX Pallas kernels in interpret mode.

Rays: the JAX test's 40x40 camera rays plus one bounce batch (random
directions about the hit normals from numpy seed 1).  On the card (``-m
chip``) the kernels walk the scene's tree and give the twin's t, index and
material rows bit for bit, and the brute-force sweep kernel's: on camera
and bounce rays, at a full and a half active_count, and on rays aimed at
every triangle's vertices and edges and grazing its plane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.camera import primary_rays
from rlrpt_tpu.ops import intersect_pallas as jip
from rlrpt_tpu.ops.intersect import closest_hit as jax_closest_hit
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu_torch.camera import Camera, pixel_rays
from rlrpt_tpu_torch.ops import bvh as bv
from rlrpt_tpu_torch.ops import intersect_pallas as ip
from rlrpt_tpu_torch.ops.hemisphere import sample_uniform_direction
from rlrpt_tpu_torch.ops.intersect import closest_hit
from _torch_parity import (card, card_scenes, cornell_plus_clutter,  # noqa: F401
                           one_torch_thread, torch_scene)

N_PRIMARY = 1600
CAM = (0.0, 0.0, -3.0)
CARD_SCENES = ("cornell", "clutter", "test_room", "torus_room")
# name, launcher, kernel, takes the material rows
LAUNCHERS = (("B4a", ip.closest_hit_mat_mxu, ip.KERNEL_MAT, True),
             ("B4b", ip.closest_hit_packed, ip.KERNEL_F32, False),
             ("B4c", ip.closest_hit_packed_mxu, ip.KERNEL_MXU, False))


def _rays(js):
    """(o, d) numpy f32: 1600 camera rays, then one bounce ray from each
    camera ray's hit."""
    o, d = primary_rays(jax.random.PRNGKey(0), JCamera.create([0., 0., -3.]),
                        40, 40, 40.0)
    h = jax_closest_hit(o, d, js)
    o, d, t = np.asarray(o), np.asarray(d), np.asarray(h.t)
    hit = t < 1e38
    nd = np.random.default_rng(1).normal(size=d.shape).astype(np.float32)
    nd /= np.linalg.norm(nd, axis=1, keepdims=True)
    nd = np.where((nd * np.asarray(h.normal)).sum(1, keepdims=True) < 0, -nd,
                  nd)
    o2 = o + np.where(hit, t, 0.0)[:, None] * d + 1e-4 * nd
    return (np.concatenate([o, o2[hit]]).astype(np.float32),
            np.concatenate([d, nd[hit]]).astype(np.float32))


@pytest.fixture(scope="module", params=["cornell", "clutter"])
def case(request):
    """(jax scene, port scene, o, d); the clutter scene has 288 triangles:
    two shared-memory tiles in the kernel, two chunks in the JAX one."""
    js = jax_cornell_box() if request.param == "cornell" else \
        cornell_plus_clutter()
    o, d = _rays(js)
    return js, torch_scene(js), o, d


def _t(a):
    return torch.from_numpy(a)


def test_packed_matches_jax(case):
    """B4b: the same triangle for every ray; t within 1 ulp on >= 95% of
    hits and within 1e-5 relative on all (JAX divides as tq * (1/det) and
    its CPU code rounds the cancelling cross-product terms its own way:
    measured 96.3% within 1 ulp, at most 4.0e-6 relative)."""
    js, ts, o, d = case
    r = o.shape[0]
    tj, ij = map(np.asarray, jip.closest_hit_packed(
        jnp.asarray(o), jnp.asarray(d), jip.pack_triangles(js), r,
        interpret=True))
    tt, it = ip.closest_hit_packed(_t(o), _t(d), ip.pack_triangles(ts), r)
    tt, it = tt.numpy(), it.numpy()
    assert it.dtype == np.int32
    assert (it == ij).mean() >= 0.999
    hit = tj < 1e38
    assert ((tt < 1e38) == hit).all() and (tt[~hit] == np.float32(3e38)).all()
    ulps = np.abs(tt.view(np.int32).astype(np.int64)
                  - tj.view(np.int32).astype(np.int64))[hit]
    assert (ulps <= 1).mean() >= 0.95
    np.testing.assert_allclose(tt[hit], tj[hit], rtol=1e-5)


def test_active_count_honoured(case):
    """Rays at index >= count come back as misses (INF, 0, zero row); the
    JAX kernel skips whole 512-ray tiles, so only rays below the count are
    compared with it."""
    js, ts, o, d = case
    count = 700
    tj, ij = map(np.asarray, jip.closest_hit_packed(
        jnp.asarray(o), jnp.asarray(d), jip.pack_triangles(js), count,
        interpret=True))
    tris, mat = ip.pack_scene_mxu(ts)
    for fn, args in ((ip.closest_hit_packed, (tris,)),
                     (ip.closest_hit_packed_mxu, (tris,)),
                     (ip.closest_hit_mat_mxu, (tris, mat))):
        out = fn(_t(o), _t(d), *args, torch.tensor([count], dtype=torch.int32))
        t, i = out[0].numpy(), out[1].numpy()
        assert (i[:count] == ij[:count]).all()
        np.testing.assert_allclose(t[:count], tj[:count], rtol=1e-5)
        assert (t[count:] == np.float32(3e38)).all() and (i[count:] == 0).all()
        if len(out) == 3:
            assert (out[2][count:] == 0).all()
    t, _ = ip.closest_hit_packed(_t(o), _t(d), tris, 0)
    assert (t.numpy() >= 1e38).all()


def test_mat_matches_jax(case):
    """B4a against the compensated-bf16 JAX kernel: the same triangle on
    >= 99.9% of rays; t within 2e-5 relative on >= 95% of the rest and
    within 5e-3 on all (grazing rays amplify the bf16 split's 1.5e-5:
    measured 96.8% and 1.9e-3); material rows within 1e-5 relative,
    class ids (row 11) exact."""
    js, ts, o, d = case
    r = o.shape[0]
    cls = np.arange(js.v0.shape[0], dtype=np.int32) % 7
    g48, m2 = jip.pack_scene_mxu(js, jnp.asarray(cls))
    tj, ij, mj = map(np.asarray, jip.closest_hit_mat_mxu(
        jnp.asarray(o), jnp.asarray(d), g48, m2, r, interpret=True))
    tris, mat = ip.pack_scene_mxu(ts, _t(cls))
    tt, it, mt = (a.numpy() for a in ip.closest_hit_mat_mxu(
        _t(o), _t(d), tris, mat, r))
    assert (it == ij).mean() >= 0.999
    same = (it == ij) & (tj < 1e38)
    rel = np.abs(tt - tj)[same] / tj[same]
    assert (rel <= 2e-5).mean() >= 0.95 and rel.max() <= 5e-3
    np.testing.assert_allclose(mt[same], mj[same], rtol=1e-5, atol=0.0)
    assert (mt[same][:, 11] == cls[it[same]]).all()
    assert (mt[tt >= 1e38] == 0).all()


def test_packed_mxu_matches_jax():
    """B4c as tests/test_wavefront.py:35-55 holds the JAX MXU kernel to
    the exact one: hit/miss and triangle agree away from grazing ties, t
    carries the compensated-bf16 error."""
    js = jax_cornell_box()
    o, d = _rays(js)
    o, d = o[:N_PRIMARY], d[:N_PRIMARY]
    t1, i1 = map(np.asarray, jip.closest_hit_packed_mxu(
        jnp.asarray(o), jnp.asarray(d), jip.pack_triangles_mxu(js), N_PRIMARY,
        interpret=True))
    t0, i0 = ip.closest_hit_packed_mxu(
        _t(o), _t(d), ip.pack_triangles(torch_scene(js)), N_PRIMARY)
    t0, i0 = t0.numpy(), i0.numpy()
    hit0, hit1 = t0 < 1e38, t1 < 1e38
    assert (hit0 == hit1).mean() > 0.999
    same = hit0 & hit1 & (i0 == i1)
    assert same.mean() > 0.98
    rel = np.abs(t1[same] - t0[same]) / np.maximum(t0[same], 1e-3)
    assert np.median(rel) < 1e-4


def test_hit_records_match_plain_closest_hit(case):
    """closest_hit_pallas(_mat) give ops.intersect.closest_hit's record;
    material_rows is the gathered layout of pack_scene_mxu's rows."""
    _, ts, o, d = case
    o, d = _t(o), _t(d)
    ref = closest_hit(o, d, ts)
    h = ip.closest_hit_pallas(o, d, ts)
    tris, mat = ip.pack_scene_mxu(ts)
    hm, rows = ip.closest_hit_pallas_mat(o, d, ts, tris, mat)
    hit = ref.t < 1e38
    for rec in (h, hm):
        assert torch.equal(rec.hit_type, ref.hit_type)
        assert torch.equal(rec.tri[hit], ref.tri[hit])
        torch.testing.assert_close(rec.t[hit], ref.t[hit], rtol=1e-5, atol=0)
        torch.testing.assert_close(rec.position, ref.position, rtol=1e-5,
                                   atol=1e-5)
    assert torch.equal(h.normal[hit], ref.normal[hit])
    assert torch.equal(hm.normal[hit], ref.normal[hit])
    assert torch.equal(rows[hit], ip.material_rows(ts, hm.tri)[hit])


def test_wrapper_validates_and_counts_nothing_on_cpu():
    tris, mat = ip.pack_scene_mxu(torch_scene(jax_cornell_box()))
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match=r"\(R, 3\)"):
        ip.closest_hit_packed(o, torch.zeros((3, 3)), tris, 4)
    with pytest.raises(ValueError, match="contiguous float32"):
        ip.closest_hit_packed(o.double(), o, tris, 4)
    with pytest.raises(ValueError, match="16 columns"):
        ip.closest_hit_mat_mxu(o, o, tris, mat[:, :8].contiguous(), 4)
    with pytest.raises(ValueError, match="no kernel"):
        ip.closest_hit_packed(o.to("meta"), o.to("meta"), tris.to("meta"), 4)
    with pytest.raises(ValueError, match="2\\^24"):
        ip.pack_scene_mxu(torch_scene(jax_cornell_box()),
                          torch.full((38,), 1 << 24))
    assert (ip.KERNEL_F32.launches, ip.KERNEL_MXU.launches,
            ip.KERNEL_MAT.launches) == (0, 0, 0)


def _card_tables(scene):
    """pack_scene_mxu's tables with class ids (index mod 7) in column 11."""
    cls = torch.arange(scene.n_triangles, device=scene.v0.device) % 7
    return ip.pack_scene_mxu(scene, cls)


def _camera_and_bounce_rays(tris, mat, size: int, seed: int):
    """size x size jittered camera rays from CAM, then one bounce ray from
    each camera ray's hit (uniform about its normal; the hits by the sweep
    kernel): (o, d), contiguous, on the table's device."""
    gen = torch.Generator(device=tris.device).manual_seed(seed)
    jitter = torch.rand((size, size, 2), generator=gen, device=tris.device)
    o, d = (a.contiguous() for a in pixel_rays(
        jitter, Camera.create(CAM), size, size, float(size)))
    t, _, rows = ip.closest_hit_sweep(o, d, tris, o.shape[0], mat)
    hit = t < 1e38
    nd, _ = sample_uniform_direction(gen, rows[:, 0:3])
    o2 = o + torch.where(hit, t, 0.0)[:, None] * d + 1e-4 * nd
    return (torch.cat([o, o2[hit]]).contiguous(),
            torch.cat([d, nd[hit]]).contiguous())


def _edge_rays(tris, seed: int):
    """Rays aimed exactly at every triangle's vertices, edge midpoints and
    a random point of each edge (so at both sides of every shared edge),
    from the camera and from random origins inside [-0.95, 0.95]^3, and
    rays grazing each triangle's plane (from outside the triangle towards
    its centroid, tilted off the plane by 1e-7 to 1e-2 rad): (o, d) on
    the table's device."""
    rng = np.random.default_rng(seed)
    r = tris.cpu().numpy()
    v0 = r[:, 0:3]
    v1, v2 = v0 + r[:, 4:7], v0 + r[:, 8:11]
    pts = []
    for a, b in ((v0, v1), (v1, v2), (v2, v0)):
        s = rng.uniform(0, 1, (len(a), 1)).astype(np.float32)
        pts += [a, (a + b) * np.float32(0.5), a + s * (b - a)]
    pts = np.concatenate(pts)
    org = np.concatenate([np.broadcast_to(np.float32(CAM), pts.shape),
                          rng.uniform(-0.95, 0.95, pts.shape)])
    d = np.concatenate([pts, pts]) - org
    cen = (v0.astype(np.float64) + v1 + v2) / 3
    n = np.cross(v1 - v0, v2 - v0).astype(np.float64)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    g_o = cen + 3.0 * ((v0 + v1) / 2 - cen)
    g_d = cen - g_o
    g_d /= np.maximum(np.linalg.norm(g_d, axis=1, keepdims=True), 1e-30)
    g_d += 10.0 ** rng.uniform(-7, -2, (len(v0), 1)) * rng.choice(
        [-1.0, 1.0], (len(v0), 1)) * n
    o = np.concatenate([org, g_o]).astype(np.float32)
    d = np.concatenate([d, g_d]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).to(tris.device), torch.from_numpy(d).to(
        tris.device)


def _assert_same_hits(got, want, count: int) -> None:
    """t's bits, index and (B4a) rows' bits equal; rays past count
    missed."""
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert bool((got[0][count:] >= 1e38).all())


@pytest.mark.chip
@pytest.mark.parametrize("name", CARD_SCENES)
def test_walks_are_the_twin_on_the_card(card_scenes, name):
    """B4a-c through the scene's tree at half the rays' count (a device
    int32), and B4c's launcher without a tree and with an int count,
    against the twin; the torus room at 256x256 camera rays (the twin
    tests all 4,980 triangles a ray), the others at 720x720."""
    tris, mat = _card_tables(card_scenes[name])
    tree = bv.build_bvh(tris)
    o, d = _camera_and_bounce_rays(tris, mat, 256 if name == "torus_room"
                                   else 720, 11)
    half = o.shape[0] // 2
    live = torch.tensor([half], dtype=torch.int32, device=o.device)
    for _, fn, kernel, rows in LAUNCHERS:
        tables = (tris, mat) if rows else (tris,)
        before = kernel.launches
        got = fn(o, d, *tables, live, bvh=tree)
        assert kernel.launches == before + 1
        _assert_same_hits(got, ip.closest_hit_plain(o, d, tris, half,
                                                    *tables[1:]), half)
    _assert_same_hits(ip.closest_hit_packed_mxu(o, d, tris, o.shape[0]),
                      ip.closest_hit_plain(o, d, tris, o.shape[0]),
                      o.shape[0])


@pytest.mark.chip
@pytest.mark.parametrize("name", CARD_SCENES)
def test_walks_are_the_sweep_on_the_card(card_scenes, name):
    """B4a-c through the tree against closest_hit_sweep (every ray against
    every triangle) on 720x720 camera rays and their bounce rays, at the
    full and at half the count, and on the edge, vertex and grazing
    rays."""
    tris, mat = _card_tables(card_scenes[name])
    tree = bv.build_bvh(tris)
    o, d = _camera_and_bounce_rays(tris, mat, 720, 11)
    e_o, e_d = _edge_rays(tris, 7)
    for r_o, r_d, count in ((o, d, o.shape[0]), (o, d, o.shape[0] // 2),
                            (e_o, e_d, e_o.shape[0])):
        live = torch.tensor([count], dtype=torch.int32, device=o.device)
        want = ip.closest_hit_sweep(r_o, r_d, tris, live, mat)
        for _, fn, _, rows in LAUNCHERS:
            got = fn(r_o, r_d, *((tris, mat) if rows else (tris,)), live,
                     bvh=tree)
            _assert_same_hits(got, want[:len(got)], count)
