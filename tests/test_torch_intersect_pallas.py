"""rlrpt_tpu_torch closest-hit launchers (the plain twin of kernels B4a-c)
vs the JAX Pallas kernels in interpret mode.

Rays: the JAX test's 40x40 camera rays plus one bounce batch (random
directions about the hit normals from numpy seed 1).  The CUDA kernel is
held against the twin on the card by chip_smoke.py.
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
from rlrpt_tpu_torch.ops import intersect_pallas as ip
from rlrpt_tpu_torch.ops.intersect import closest_hit
from _torch_parity import (cornell_plus_clutter, one_torch_thread,  # noqa: F401
                           torch_scene)

N_PRIMARY = 1600


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
