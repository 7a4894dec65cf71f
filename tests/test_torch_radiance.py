"""rlrpt_tpu_torch's fine radiance map (radiance/*, the hemisphere sector
samplers, utils/stats) against rlrpt_tpu's on the CPU.

Both sides start from the same state: the JAX objects' arrays go to the
port through utils/convert.py, and random inputs are made with numpy from
fixed seeds.  The samplers' deterministic cores take the uniforms JAX
draws, so their sectors match draw for draw.  On the card (``-m chip``)
the dense nearest-volume search is held against a float64 brute force.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlrpt_tpu.config import RadianceVolumeConfig as JRL
from rlrpt_tpu.ops import hemisphere as jhs
from rlrpt_tpu.radiance import bake as jbake
from rlrpt_tpu.radiance import grid_bucket as jgb
from rlrpt_tpu.radiance import interpolation as jinterp
from rlrpt_tpu.radiance import map_io as jio
from rlrpt_tpu.radiance import nn_search as jnn
from rlrpt_tpu.radiance import visualize as jvis
from rlrpt_tpu.radiance import volumes as jv
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu.scene.geometry import sample_points_on_triangles as j_sample
from rlrpt_tpu.utils.stats import StatsLogger as JStatsLogger
from rlrpt_tpu_torch.config import RadianceVolumeConfig
from rlrpt_tpu_torch.ops import hemisphere as hs
from rlrpt_tpu_torch.radiance import bake, grid_bucket as gb, interpolation
from rlrpt_tpu_torch.radiance import map_io, nn_search, visualize
from rlrpt_tpu_torch.radiance import volumes as tv
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.scene.geometry import sample_points_on_triangles
from rlrpt_tpu_torch.utils import convert
from rlrpt_tpu_torch.utils.stats import StatsLogger, read_stats
from rlrpt_tpu_torch.scene.scene import surface_areas
from _torch_parity import card, one_torch_thread, torch_scene  # noqa: F401

A = np.asarray


def _t(a):
    return torch.from_numpy(np.array(a))


def port_vols(jvols):
    """The port's RadianceVolumes holding a JAX map's arrays."""
    return convert.volumes_from_numpy(
        jvols.position, jvols.normal, jvols.frame, jvols.surface_lum,
        jvols.q, jvols.visits, jvols.cdf, jvols.grid_resolution)


def skewed(jvols, seed=3, power=4):
    """The JAX map with a skewed, volume-dependent Q (numpy seed) and its
    rebuilt CDF."""
    u = np.random.default_rng(seed).random(jvols.q.shape)
    q = jnp.asarray((u ** power + 1e-3).astype(np.float32))
    return jv.rebuild_cdf(dataclasses.replace(jvols, q=q))


@pytest.fixture(scope="module")
def maps():
    """(JAX scene, port scene, JAX map at area 0.05 with a skewed Q, the
    same map in the port)."""
    js = jax_cornell_box()
    jvols = skewed(jv.build_radiance_volumes(js, JRL(area_per_sample=0.05)))
    return js, torch_scene(js), jvols, port_vols(jvols)


def surface_queries(js, n, seed=7):
    """n points on random surface triangles with their triangles' normals
    (numpy f32)."""
    rng = np.random.default_rng(seed)
    ns = js.n_surfaces
    tri = rng.integers(0, ns, n)
    u, v = rng.random(n), rng.random(n)
    fold = u + v > 1
    u[fold], v[fold] = 1 - u[fold], 1 - v[fold]
    v0 = A(js.v0)[tri]
    p = v0 + u[:, None] * (A(js.v1)[tri] - v0) + v[:, None] * (
        A(js.v2)[tri] - v0)
    return p.astype(np.float32), A(js.normal, np.float32)[tri], tri


# ---- geometry, volume set, hemisphere ---------------------------------------

@pytest.mark.parametrize("area", [0.05, 0.001], ids=["a0.05", "a0.001"])
def test_volume_set_bit_equal(area):
    """build_radiance_volumes: positions, normals and surface_lum bit-equal
    to JAX's (V = 24,526 at the default 0.001); frames within 1e-6; the
    initial Q, visits and CDF equal."""
    js = jax_cornell_box()
    rl_j, rl_t = JRL(area_per_sample=area), RadianceVolumeConfig(
        area_per_sample=area)
    jvols = jv.build_radiance_volumes(js, rl_j)
    tvols = tv.build_radiance_volumes(cornell_box(device="cpu"), rl_t)
    assert tvols.n_volumes == jvols.n_volumes
    assert (tv.volume_counts(cornell_box(device="cpu"), rl_t)
            == jv.volume_counts(js, rl_j)).all()
    if area == 0.001:
        assert tvols.n_volumes == 24526
    for name in ("position", "normal", "surface_lum", "q", "visits", "cdf"):
        a, b = getattr(tvols, name).numpy(), A(getattr(jvols, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    np.testing.assert_allclose(tvols.frame.numpy(), A(jvols.frame), rtol=0,
                               atol=1e-6)
    assert rl_t.grid_rho == rl_j.grid_rho


def test_sample_points_and_areas_bit_equal():
    js = jax_cornell_box()
    ns = js.n_surfaces
    v = [A(a, np.float64)[:ns] for a in (js.v0, js.v1, js.v2)]
    counts = np.arange(ns) % 5
    pj, tj = j_sample(np.random.default_rng(11), *v, counts)
    pt, tt = sample_points_on_triangles(np.random.default_rng(11), *v, counts)
    assert np.array_equal(pj, pt) and np.array_equal(tj, tt)


def test_hemisphere_sector_helpers():
    """sector_index_to_grid, grid_pos_to_direction, the jittered sector
    direction on JAX's uniforms, and dirs_to_sector_cos."""
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 144, 500)
    for a, b in zip(jhs.sector_index_to_grid(jnp.asarray(idx), 12),
                    hs.sector_index_to_grid(_t(idx), 12)):
        assert np.array_equal(A(a), b.numpy())
    n = rng.normal(size=(500, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    from rlrpt_tpu.ops.linalg import make_frame as jframe
    from rlrpt_tpu_torch.ops.linalg import make_frame
    fr_j, fr_t = jframe(jnp.asarray(n)), make_frame(_t(n))
    key = jax.random.PRNGKey(4)
    d_j = jhs.sample_sector_direction(key, jnp.asarray(idx), fr_j, 12)
    u = jax.random.uniform(key, (500, 2), dtype=jnp.float32)
    d_t = hs.sector_direction(_t(u), _t(idx), fr_t, 12)
    np.testing.assert_allclose(d_t.numpy(), A(d_j), atol=2e-6)
    g = torch.Generator().manual_seed(0)
    d_g = hs.sample_sector_direction(g, _t(idx), fr_t, 12)
    np.testing.assert_allclose(torch.linalg.norm(d_g, dim=-1).numpy(), 1.0,
                               atol=1e-5)
    assert ((d_g * fr_t[:, 1]).sum(-1) >= -1e-6).all()   # upper hemisphere
    np.testing.assert_allclose(hs.dirs_to_sector_cos(fr_t[:7], 12).numpy(),
                               A(jhs.dirs_to_sector_cos(fr_j[:7], 12)),
                               atol=2e-6)


# ---- CDF, irradiance, samplers, TD ------------------------------------------

@pytest.mark.parametrize("mix", [0.0, 0.1], ids=["mix0", "mix0.1"])
def test_cdf_and_irradiance(maps, mix):
    _, _, jvols, tvols = maps
    jr = jv.rebuild_cdf(jvols, 0.0, mix)
    tr = tv.rebuild_cdf(tvols, 0.0, mix)
    np.testing.assert_allclose(tr.cdf.numpy(), A(jr.cdf), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tv.irradiance_estimates(tr).numpy(),
                               A(jv.irradiance_estimates(jr)), rtol=1e-5,
                               atol=1e-7)


def _jax_uniforms(key, n, shapes):
    keys = jax.random.split(key, len(shapes))
    return [_t(jax.random.uniform(k, (n,) + sh, dtype=jnp.float32))
            for k, sh in zip(keys, shapes)]


@pytest.mark.parametrize("sampler", ["row", "bsearch", "hier", "max"])
def test_sampler_core_on_jax_uniforms(maps, sampler):
    """The port's sampler cores on the uniforms JAX draws (split(key) as
    in volumes.py:180-181): sectors equal on >= 99.9%, pdf within rtol
    1e-5, directions within 2e-6."""
    _, _, jvols, tvols = maps
    n = 4000
    idx = np.random.default_rng(5).integers(0, jvols.n_volumes, n)
    key = jax.random.PRNGKey(9)
    rho = JRL().grid_rho
    ji = jnp.asarray(idx, jnp.int32)
    if sampler == "row":
        dj, sj, pj = jv.sample_from_cdf(key, jvols, ji, rho)
        r, u = _jax_uniforms(key, n, [(1,), (2,)])
        dt, st, pt = tv.sample_from_cdf_rows_u(
            r, u, tvols.cdf[idx], tvols.frame[idx], rho, 12)
    elif sampler == "bsearch":
        dj, sj, pj = jv.sample_from_cdf_bsearch(key, jvols, ji, rho)
        r, u = _jax_uniforms(key, n, [(), (2,)])
        dt, st, pt = tv.sample_from_cdf_bsearch_u(r, u, tvols, _t(idx), rho)
    elif sampler == "hier":
        cc, cf = jv.hier_cdf_tables(jvols.cdf, 12)
        dj, sj, pj = jv.sample_from_cdf_hier(key, cc, cf, jvols.frame[ji], ji,
                                             rho, 12)
        tc, tf = tv.hier_cdf_tables(tvols.cdf, 12)
        np.testing.assert_allclose(tc.numpy(), A(cc), rtol=0, atol=0)
        np.testing.assert_allclose(tf.numpy(), A(cf), rtol=1e-6, atol=1e-7)
        u1, u2, u = _jax_uniforms(key, n, [(1,), (1,), (2,)])
        dt, st, pt = tv.sample_from_cdf_hier_u(u1, u2, u, tc, tf,
                                               tvols.frame[idx], _t(idx),
                                               rho, 12)
    else:
        dj, sj, pj = jv.sample_max_from_cdf(key, jvols, ji, rho)
        u = _t(jax.random.uniform(key, (n, 2), dtype=jnp.float32))
        dt, st, pt = tv.sample_max_from_cdf_u(u, tvols, _t(idx), rho)
    same = st.numpy() == A(sj)
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(pt.numpy()[same], A(pj)[same], rtol=1e-5)
    np.testing.assert_allclose(dt.numpy()[same], A(dj)[same], atol=2e-6)
    # the generator-drawn wrapper gives valid sectors with their pdfs
    g = torch.Generator().manual_seed(1)
    if sampler == "row":
        _, s2, p2 = tv.sample_from_cdf(g, tvols, _t(idx), rho)
        rows = tvols.cdf[idx]
        lo = torch.where(s2 > 0, rows.gather(1, (s2 - 1).clamp(min=0)[:, None])
                         [:, 0], 0.0)
        hi = torch.where(s2 == 143, 1.0, rows.gather(1, s2[:, None])[:, 0])
        torch.testing.assert_close(p2, (hi - lo) / (2 * np.pi) / rho)


def test_hier_and_row_samplers_same_distribution(maps):
    """Over many draws from one skewed volume the two-level sampler's
    sector histogram matches the flat one's (total variation < 0.02)."""
    _, _, _, tvols = maps
    n = 60000
    idx = torch.full((n,), 3, dtype=torch.int64)
    g = torch.Generator().manual_seed(5)
    _, s_row, _ = tv.sample_from_cdf(g, tvols, idx, 1 / 144)
    tc, tf = tv.hier_cdf_tables(tvols.cdf, 12)
    _, s_h, _ = tv.sample_from_cdf_hier(g, tc, tf, tvols.frame[idx], idx,
                                        1 / 144, 12)
    h1 = np.bincount(s_row.numpy(), minlength=144) / n
    h2 = np.bincount(s_h.numpy(), minlength=144) / n
    assert 0.5 * np.abs(h1 - h2).sum() < 0.02


def test_td_contributions_and_update(maps):
    """sarsa_contributions: counts exactly JAX's, sums within rtol 1e-5;
    apply_sarsa_contributions: q within rtol 1e-6, visits equal; the
    preallocated scratch gives the same answer on reuse."""
    _, _, jvols, tvols = maps
    rng = np.random.default_rng(6)
    n, v, s = 5000, jvols.n_volumes, 144
    vol = rng.integers(0, v, n).astype(np.int32)
    sec = rng.integers(0, s, n).astype(np.int32)
    tgt = rng.random(n).astype(np.float32)
    mask = rng.random(n) < 0.7
    sj, cj = jv.sarsa_contributions(jnp.asarray(vol), jnp.asarray(sec),
                                    jnp.asarray(tgt), jnp.asarray(mask), v, s)
    scratch = tv.td_scratch(v, s, "cpu")
    for _ in range(2):
        st, ct = tv.sarsa_contributions(_t(vol), _t(sec), _t(tgt), _t(mask),
                                        v, s, scratch)
        assert np.array_equal(ct.numpy(), A(cj))
        np.testing.assert_allclose(st.numpy(), A(sj), rtol=1e-5, atol=0)
    visits = rng.integers(0, 4, (v, s)).astype(np.int32)
    jvv = dataclasses.replace(jvols, visits=jnp.asarray(visits))
    tvv = dataclasses.replace(tvols, visits=_t(visits))
    uj = jv.apply_sarsa_contributions(jvv, sj, cj, 0.8 / 144)
    ut = tv.apply_sarsa_contributions(tvv, _t(sj), _t(cj), 0.8 / 144)
    np.testing.assert_allclose(ut.q.numpy(), A(uj.q), rtol=1e-6, atol=0)
    assert np.array_equal(ut.visits.numpy(), A(uj.visits))
    ej = jv.expected_sarsa_update(jvv, jnp.asarray(vol), jnp.asarray(sec),
                                  jnp.asarray(tgt), jnp.asarray(mask),
                                  0.8 / 144)
    et = tv.expected_sarsa_update(tvv, _t(vol), _t(sec), _t(tgt), _t(mask),
                                  0.8 / 144)
    np.testing.assert_allclose(et.q.numpy(), A(ej.q), rtol=1e-5, atol=0)
    assert int((et.visits - tvv.visits).sum()) == int(mask.sum())


# ---- nearest-volume search ---------------------------------------------------

def test_dense_search_matches_jax(maps):
    """find_closest_volume / find_k_closest_volumes: equal indices except
    at exact distance ties (>= 99.9%), tiled and untiled."""
    js, _, jvols, tvols = maps
    p, n, _ = surface_queries(js, 3000)
    ij = A(jnn.find_closest_volume(jvols, jnp.asarray(p), jnp.asarray(n)))
    for tile in (2048, 700):
        it = nn_search.find_closest_volume(tvols, _t(p), _t(n),
                                           query_tile=tile).numpy()
        assert (it == ij).mean() >= 0.999
    kj, vj = map(A, jnn.find_k_closest_volumes(jvols, jnp.asarray(p),
                                               jnp.asarray(n), k=3))
    kt, vt = nn_search.find_k_closest_volumes(tvols, _t(p), _t(n), k=3,
                                              query_tile=1000)
    assert (kt.numpy() == kj).all(axis=1).mean() >= 0.999
    assert np.array_equal(vt.numpy(), vj)


@pytest.mark.chip
def test_dense_search_on_the_card(card):
    """On the card, with cuBLAS's f32 matmul (TF32 off), against a float64
    brute force at the fine map's Cornell volumes (area_per_sample
    0.001): the same volume for >= 99.9% of 20,000 surface points."""
    scene = cornell_box(device=card)
    vols = tv.build_radiance_volumes(
        scene, RadianceVolumeConfig(area_per_sample=0.001))
    ns = scene.n_surfaces
    v0, v1, v2 = (a[:ns].cpu().numpy().astype(np.float64)
                  for a in (scene.v0, scene.v1, scene.v2))
    area = surface_areas(scene)
    rng = np.random.default_rng(12)
    qp, qt = sample_points_on_triangles(
        rng, v0, v1, v2, rng.multinomial(20_000, area / area.sum()))
    qpos = torch.as_tensor(qp, device=card)
    qnrm = scene.normal[torch.as_tensor(qt, device=card)]
    got = nn_search.find_closest_volume(vols, qpos, qnrm)
    want = []
    for i in range(0, qpos.shape[0], 1024):
        d2 = ((qpos[i:i + 1024, None].double()
               - vols.position[None].double()) ** 2).sum(-1)
        same = (qnrm[i:i + 1024, None] == vols.normal[None]).all(-1)
        want.append(torch.argmin(d2 + torch.where(same, 0.0, 1e12), -1))
    want = torch.cat(want)
    assert vols.n_volumes > 20_000
    assert float((got == want).double().mean()) >= 0.999


def test_grid_and_class_table_bit_equal():
    """The VolumeGrid payload and the VolumeClassTable table are JAX's bit
    for bit; the two queries give JAX's answers on >= 99.9% of surface
    points (the table's with and without the caller's class ids)."""
    js = jax_cornell_box()
    jvols = jv.build_radiance_volumes(js, JRL(area_per_sample=0.01))
    tvols = port_vols(jvols)
    ts = torch_scene(js)
    jg, tg = jgb.build_volume_grid(jvols), gb.build_volume_grid(tvols)
    assert np.array_equal(tg.payload.numpy(), A(jg.payload))
    assert np.array_equal(tg.origin.numpy(), A(jg.origin))
    assert float(tg.inv_cell) == float(jg.inv_cell) and tg.dims == jg.dims
    jt, tt = jgb.build_volume_class_table(jvols, js), \
        gb.build_volume_class_table(tvols, ts)
    assert np.array_equal(tt.table.numpy(), A(jt.table))
    assert np.array_equal(tt.tri_class.numpy(), A(jt.tri_class))
    assert tt.dims == jt.dims and tt.nbytes == jt.nbytes
    p, n, tri = surface_queries(js, 4000, seed=8)
    aj = A(jgb.find_closest_volume_grid(jg, jnp.asarray(p), jnp.asarray(n)))
    at = gb.find_closest_volume_grid(tg, _t(p), _t(n)).numpy()
    assert (at == aj).mean() >= 0.999
    bj = A(jgb.find_closest_volume_table(jt, jnp.asarray(p),
                                         jnp.asarray(tri, jnp.int32)))
    bt = gb.find_closest_volume_table(tt, _t(p), _t(tri)).numpy()
    assert (bt == bj).mean() >= 0.999
    bc = gb.find_closest_volume_table(tt, _t(p), _t(tri),
                                      cls=tt.tri_class[_t(tri)]).numpy()
    assert np.array_equal(bc, bt)
    # far queries clamp into the grid; inf stays a valid index
    far = torch.tensor([[50.0, 50.0, 50.0], [3e38, -3e38, 0.0]])
    for ans in (gb.find_closest_volume_grid(tg, far, torch.zeros((2, 3))),
                gb.find_closest_volume_table(tt, far, torch.zeros(2).long())):
        assert ((ans >= 0) & (ans < tvols.n_volumes)).all()
    with pytest.raises(ValueError, match="n_slots"):
        gb.build_volume_class_table(tvols, ts, n_slots=5)
    jc = convert.volume_class_table_from_numpy(
        jt.table, jt.tri_class, jt.origin, jt.inv_cell, jt.dims, jt.n_slots)
    assert np.array_equal(gb.find_closest_volume_table(jc, _t(p),
                                                       _t(tri)).numpy(), bt)
    jgc = convert.volume_grid_from_numpy(jg.payload, jg.origin, jg.inv_cell,
                                         jg.dims, jg.k_max)
    assert np.array_equal(gb.find_closest_volume_grid(jgc, _t(p),
                                                      _t(n)).numpy(), at)


def test_class_table_memory_budget():
    """A budget below the default table's size coarsens the cell as the
    JAX builder does (same dims)."""
    js = jax_cornell_box()
    jvols = jv.build_radiance_volumes(js, JRL(area_per_sample=0.02))
    capped_j = jgb.build_volume_class_table(jvols, js,
                                            mem_budget_bytes=1 << 20)
    capped = gb.build_volume_class_table(port_vols(jvols), torch_scene(js),
                                         mem_budget_bytes=1 << 20)
    assert capped.dims == capped_j.dims
    assert capped.table.numel() * 4 <= 1 << 20
    assert np.array_equal(capped.table.numpy(), A(capped_j.table))


# ---- map IO, bake, interpolation, visualisation, stats ----------------------

def test_map_io_text_and_npz(maps, tmp_path):
    """Q text and selected-volume text byte-equal to the JAX writer's; the
    text, selected and npz reloads round-trip."""
    js, _, jvols, tvols = maps
    jio.save_q_vals_to_file(jvols, str(tmp_path / "j.txt"))
    map_io.save_q_vals_to_file(tvols, str(tmp_path / "t.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    pos, q, s = map_io.load_radiance_map_data(str(tmp_path / "t.txt"))
    assert s == 144 and q.shape == tuple(tvols.q.shape)
    np.testing.assert_allclose(q, tvols.q.numpy(), rtol=1e-5)   # %.6g
    np.testing.assert_allclose(pos, tvols.position.numpy(), rtol=1e-5,
                               atol=1e-7)

    p, n, _ = surface_queries(js, 9, seed=4)
    probe = tmp_path / "to_select.txt"
    probe.write_text("".join(" ".join(f"{x:.6f}" for x in np.r_[a, b]) + "\n"
                             for a, b in zip(p, n)))
    jio.save_selected_volumes(jvols, str(probe), str(tmp_path / "js.txt"))
    map_io.save_selected_volumes(tvols, str(probe), str(tmp_path / "ts.txt"))
    assert (tmp_path / "ts.txt").read_bytes() == \
        (tmp_path / "js.txt").read_bytes()
    sel = map_io.load_volumes_from_selected(str(tmp_path / "ts.txt"),
                                            device="cpu")
    jsel = jio.load_volumes_from_selected(str(tmp_path / "ts.txt"))
    assert sel.n_volumes == 9
    np.testing.assert_allclose(sel.cdf.numpy(), A(jsel.cdf), rtol=1e-5,
                               atol=1e-7)

    map_io.save_volumes_npz(tvols, str(tmp_path / "v.npz"))
    back = map_io.load_volumes_npz(str(tmp_path / "v.npz"), device="cpu")
    for f in ("position", "normal", "frame", "surface_lum", "q", "visits",
              "cdf"):
        assert torch.equal(getattr(back, f), getattr(tvols, f)), f
    jback = jio.load_volumes_npz(str(tmp_path / "v.npz"))
    assert np.array_equal(A(jback.q), tvols.q.numpy())


def test_bake_matches_jax(maps):
    """bake_tri_bin_cdf of a skewed map at sector_grid 11, uv_bins 4 (the
    EVAL setting) and 12/2: bf16 entries equal on >= 99.99%, elsewhere
    within 1 bf16 ulp; rebin_sector_pmf exact."""
    js, ts, jvols, tvols = maps
    rl_j, rl_t = JRL(area_per_sample=0.05), RadianceVolumeConfig(
        area_per_sample=0.05)
    pmf = np.random.default_rng(1).random((5, 144))
    np.testing.assert_array_equal(bake.rebin_sector_pmf(pmf, 12, 11),
                                  jbake.rebin_sector_pmf(pmf, 12, 11))
    for sg, ub in ((11, 4), (12, 2)):
        tj = jbake.bake_tri_bin_cdf(js, jvols, rl_j, 40, uv_bins=ub,
                                    sector_grid=sg)
        tt = bake.bake_tri_bin_cdf(ts, tvols, rl_t, 40, uv_bins=ub,
                                   sector_grid=sg)
        assert (tt.sector_grid, tt.uv_bins, tt.t_pad) == (sg, ub, 40)
        assert tt.cdf.dtype == torch.bfloat16
        a = tt.cdf.float().numpy()
        b = A(tj.cdf.astype(jnp.float32))
        assert a.shape == b.shape
        eq = a == b
        assert eq.mean() >= 0.9999
        ulp = np.abs(a.view(np.int32) - b.view(np.int32)) >> 16
        assert (ulp[~eq] <= 1).all()
    with pytest.raises(ValueError, match="volume_counts"):
        bake.bake_tri_bin_cdf(ts, tvols, RadianceVolumeConfig(), 40)


def test_interpolation_matches_jax(maps):
    js, ts, jvols, tvols = maps
    p, n, tri = surface_queries(js, 600, seed=9)
    rgb = A(js.diffuse_c)[tri]
    ij, vj = map(A, jinterp.find_k_closest_volumes(
        jvols, jnp.asarray(p), jnp.asarray(n), k=3, max_dist=0.5))
    for tile in (2048, 250):
        it, vt = interpolation.find_k_closest_volumes(tvols, _t(p), _t(n), 3,
                                                      0.5, query_tile=tile)
        assert (it.numpy() == ij).all(axis=1).mean() >= 0.999
        assert np.array_equal(vt.numpy(), vj)
    oj = A(jinterp.interpolated_irradiance(jvols, jnp.asarray(p),
                                           jnp.asarray(n), jnp.asarray(rgb)))
    ot = interpolation.interpolated_irradiance(tvols, _t(p), _t(n), _t(rgb))
    np.testing.assert_allclose(ot.numpy(), oj, rtol=1e-5, atol=1e-7)
    u = [A(x) for x in jinterp.barycentric_uvw(*(jnp.asarray(p[i::3][:100])
                                                 for i in range(3)),
                                               jnp.asarray(p[:100]))]
    w = interpolation.barycentric_uvw(*(_t(p[i::3][:100]) for i in range(3)),
                                      _t(p[:100]))
    for a, b in zip(w, u):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)


def test_volume_meshes_match_jax(maps):
    js, ts, jvols, tvols = maps
    for a, b in zip(visualize.volumes_to_surfaces(tvols, indices=[0, 5]),
                    jvis.volumes_to_surfaces(jvols, indices=[0, 5])):
        np.testing.assert_allclose(a, b, atol=2e-6)
    s2 = visualize.inject_volumes_into_scene(ts, tvols, indices=[0])
    assert s2.n_surfaces == ts.n_surfaces + 2 * 144
    assert s2.n_triangles == ts.n_triangles + 2 * 144


def test_stats_file_byte_equal(tmp_path):
    rows = [(5.123456789, 0.0, 1234), (4.5, 1.25, 0), (80.0, 0.0, 518400)]
    j, t = JStatsLogger(str(tmp_path / "j.txt")), StatsLogger(
        str(tmp_path / "t.txt"))
    for r in rows:
        j.append(*r)
        t.append(*r)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert read_stats(str(tmp_path / "t.txt")) == [
        (float(a), float(b), int(c)) for a, b, c in rows]
    StatsLogger(str(tmp_path / "t.txt"), reset=True)
    assert not (tmp_path / "t.txt").exists()
