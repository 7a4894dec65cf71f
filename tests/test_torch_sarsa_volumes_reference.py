"""The fine-map expected-SARSA tracer of rlrpt_tpu_torch held to the
benchmark's plain reference (benchmark/reference/sarsa_volumes.py) on the
Cornell box at 12x12 sectors, stage by stage on the CPU: the volume set and
the class ids exactly, the answer table's nearest volumes, and one captured
wavefront step on seeded random skewed Q tables (the closest hit against
the reference's sweep, the volume, the TD scatter and running means, the
irradiance refresh, the sector on shared uniforms, the transport), the
frame's CDF rebuild and image; the capture hook leaves every frame as it
was; each fault the benchmark's cell plants is caught.

Every tolerance states why it holds, and each comparison is shown failing
for the reference computed in bfloat16, so none is loose enough to pass a
computation one precision lower."""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from benchmark.loops import common
from benchmark.loops import sarsa_fast_frames as sff
from benchmark.reference import neural_q as nqr
from benchmark.reference import pathtrace as pt
from benchmark.reference import sarsa_volumes as svr
from benchmark.reference import scenes as ref_scenes
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.integrators import sarsa_wavefront as sw
from rlrpt_tpu_torch.radiance.grid_bucket import (build_volume_class_table,
                                                  find_closest_volume_table)
from rlrpt_tpu_torch.radiance.nn_search import find_closest_volume
from rlrpt_tpu_torch.radiance.volumes import (build_radiance_volumes,
                                              rebuild_cdf)
from rlrpt_tpu_torch.scene import cornell_box

G = 12
RL = RadianceVolumeConfig(area_per_sample=0.01)     # 2,438 volumes
CFG = RenderConfig(width=32, height=32, samples_per_pixel=2,
                   max_ray_bounces=8)
CAM = (0.0, 0.0, -3.0)
BF16 = torch.bfloat16
# the answer table's cell at 2,438 volumes: a quarter of 3x their median
# spacing (grid_bucket.build_volume_class_table), 0.0357 a side
CELL = 0.03570471704006195
CONFIG = {"width": 32, "height": 32, "max_ray_bounces": 8,
          "russian_roulette": False, "environment_light": 0.0, "eps": 1e-5,
          "camera": list(CAM),
          "volumes": {"radiance_threshold": RL.radiance_threshold},
          "answer_table": {"cell": CELL, "margin": 1e-3}}


@pytest.fixture(scope="module")
def setup():
    scene = cornell_box(device="cpu")
    tables = ref_scenes.cornell()
    vols = build_radiance_volumes(scene, RL)
    table = build_volume_class_table(vols, scene)
    ref = svr.volume_set(tables, RL.area_per_sample, G, RL.initial_radiance,
                         1984)
    return scene, tables, vols, table, ref


def _skewed(vols, seed):
    """The volumes with seeded random skewed Q (log-normal about the
    initial radiance, clamped at the threshold) and visits, CDF rebuilt."""
    g = torch.Generator().manual_seed(seed)
    q = torch.clamp(RL.initial_radiance
                    * torch.exp(2.0 * torch.randn(vols.q.shape, generator=g)),
                    min=RL.radiance_threshold)
    visits = torch.randint(0, 40, vols.visits.shape, generator=g,
                           dtype=torch.int32)
    return rebuild_cdf(dataclasses.replace(vols, q=q, visits=visits))


def _rel_each(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / b.abs()).max())


@pytest.mark.parametrize("area", [0.001, 0.01])
def test_the_volume_set_equals_the_references(area):
    """Exact: the same float32 areas, the same numpy draws, the same
    float64 points rounded once; the frames within 1e-6 (the tangent is
    normalised by a division here and by rsqrt there).  In bfloat16 the
    positions move by up to 2^-9."""
    scene, tables = cornell_box(device="cpu"), ref_scenes.cornell()
    rl = RadianceVolumeConfig(area_per_sample=area)
    vols = build_radiance_volumes(scene, rl)
    ref = svr.volume_set(tables, area, G, rl.initial_radiance, 1984)
    assert vols.n_volumes == (24_526 if area == 0.001 else 2_438)
    got = {k: getattr(vols, k) for k in ("position", "normal", "surface_lum",
                                         "q", "visits", "cdf")}
    assert sff.init_gap(got, ref) == 0.0
    torch.testing.assert_close(vols.frame, ref["frame"], rtol=0.0, atol=1e-6)
    low = svr.volume_set(tables, area, G, rl.initial_radiance, 1984, ft=BF16)
    assert sff.init_gap(low, ref) > 1e-4


def test_the_class_ids_are_the_references(setup):
    scene, tables, _, table, _ = setup
    assert torch.equal(table.tri_class.long(),
                       torch.as_tensor(svr.class_ids(tables)))


def _surface_points(tables, n, seed):
    """(points, normals, triangles) of ``n`` uniform points on the
    surfaces."""
    g = np.random.default_rng(seed)
    tri = g.integers(0, tables.n_surfaces, n)
    a = g.random((n, 2))
    a[a.sum(1) > 1] = 1 - a[a.sum(1) > 1]
    v0, v1, v2 = tables.v0[tri], tables.v1[tri], tables.v2[tri]
    qpos = torch.as_tensor((v0 + a[:, :1] * (v1 - v0)
                            + a[:, 1:] * (v2 - v0)).astype(np.float32))
    return qpos, torch.as_tensor(tables.normal[tri]), torch.as_tensor(tri)


def test_the_answer_table_answers_the_nearest_at_each_cells_centre(setup):
    """Every answer of the table for 20,000 points on the surfaces is a
    nearest volume of the point's normal to its cell's centre (ties
    within 1e-5), and so lies within the stated cell's allowance of the
    point's own nearest; brute force in bfloat16 answers otherwise in more
    than 1% of them.  Without the table, the port's dense search answers a
    nearest volume too, within 1e-5 of the reference's distance (it takes
    |q|^2 + |v|^2 - 2 q.v, whose cancellation moves near ties)."""
    scene, tables, vols, table, ref = setup
    qpos, qn, tri = _surface_points(tables, 20_000, 3)
    ans = find_closest_volume_table(table, qpos, tri)
    centres = svr.table_centres(qpos, table.origin, table.inv_cell,
                                table.dims)
    assert bool(svr.admissible(ans, centres, qn, ref["position"],
                               ref["normal"]).all())
    slack = svr.allowance(qpos, ref["position"], CELL, 1e-3)
    assert bool(svr.admissible(ans, qpos, qn, ref["position"],
                               ref["normal"], slack).all())
    low = svr.nearest(centres, qn, ref["position"], ref["normal"], ft=BF16)[0]
    bad = ~svr.admissible(low, centres, qn, ref["position"], ref["normal"])
    assert float(bad.double().mean()) > 0.01
    idx, dist = svr.nearest(qpos, qn, ref["position"], ref["normal"])
    assert bool(torch.isfinite(dist).all())
    dense = find_closest_volume(vols, qpos, qn)
    assert float((dense == idx).double().mean()) > 0.99
    assert bool(svr.admissible(dense, qpos, qn, ref["position"],
                               ref["normal"]).all())
    # the engine's reach: a point farther than it from its class finds 0
    far = svr.nearest(qpos[:1] + 10.0, qn[:1], ref["position"],
                      ref["normal"], reach=math.sqrt(0.003))
    assert int(far[0][0]) == 0 and not bool(torch.isfinite(far[1]).any())


@pytest.fixture(scope="module")
def frame(setup):
    """A 32x32, 2-spp learning frame (256 slots drained to 64) from skewed
    tables, step 3 and the tail captured: (capture, image, tables in,
    tables out)."""
    scene, _, vols, table, _ = setup
    vin = _skewed(vols, 7)
    cap = sw.Capture(iterations=(3,), tail=True)
    sw.CAPTURE = cap
    try:
        img, vout, _ = sw.render_frame_sarsa_wavefront(
            21, scene, Camera.create(CAM), vin, table, CFG, RL, pix_mux=4,
            min_drain_w=64)
    finally:
        sw.CAPTURE = None
    return cap, img, vin, vout


def _masks(rec, tables):
    st = rec["state"]
    return nqr.hit_masks(st.active, rec["t"], rec["tri"], tables.n_surfaces)


def test_the_steps_closest_hit_and_class_ids(setup, frame):
    """B4a's twin walks the frame's tree and the reference sweeps every
    triangle, both by one float32 Moller-Trumbore: the same triangle and
    distance on every live ray, bit for bit; the class id in the material
    row is the reference's class of that triangle.  The sweep in bfloat16
    lands on other triangles."""
    _, tables, _, _, _ = setup
    cap = frame[0]
    rec = cap.records[3]
    st = rec["state"]
    act = st.active
    tris, _ = tables.packed("cpu")

    def sweep(ft):
        o, d = st.o.to(ft), st.d.to(ft)
        return pt.closest_hit(o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                              d[:, 2], tris.to(ft))[:2]
    t, tri = sweep(torch.float32)
    hit = act & (t < nqr.INF_CUT)
    assert bool(hit.any())
    assert torch.equal(rec["t"][hit], t[hit])
    assert torch.equal(rec["tri"][hit], tri[hit])
    cls = torch.as_tensor(svr.class_ids(tables))
    assert torch.equal(rec["mrow"][hit, 11].long(), cls[tri[hit]])
    t_low, tri_low = sweep(BF16)
    assert bool((tri_low[hit] != tri[hit]).any())


def test_the_steps_volumes_are_the_tables_answers(setup, frame):
    """Every surface hit's volume is a nearest volume of its triangle's
    normal to the centre of the table's cell that holds it (ties within
    1e-5), so within the stated cell's allowance of the hit's nearest;
    bfloat16 brute force answers otherwise at the centres."""
    _, tables, _, table, ref = setup
    rec = frame[0].records[3]
    st = rec["state"]
    _, _, surf = _masks(rec, tables)
    qpos = (st.o + rec["t"][:, None] * st.d)[surf]
    qn = torch.as_tensor(tables.normal)[rec["tri"][surf]]
    centres = svr.table_centres(qpos, table.origin, table.inv_cell,
                                table.dims)
    geo = (centres, qn, ref["position"], ref["normal"])
    assert bool(svr.admissible(rec["next_vol"][surf], *geo).all())
    low = svr.nearest(centres, qn, ref["position"], ref["normal"], ft=BF16)[0]
    assert not bool(svr.admissible(low, *geo).all())
    slack = svr.allowance(qpos, ref["position"], CELL, 1e-3)
    assert bool(svr.admissible(rec["next_vol"][surf], qpos, qn,
                               ref["position"], ref["normal"], slack).all())


def test_a_coarser_table_fails_the_stated_cells_allowance(setup):
    """A table of cells twice the stated side answers beyond the stated
    allowance for a share of surface points past the cell's 1e-3 limit on
    ``vol_gap`` (0.38% here, 0.45% at 24,526 volumes; the stated table
    none, and 19% of its answers are not the point's nearest), though
    each answer is its own cell centre's nearest."""
    scene, tables, vols, _, ref = setup
    coarse = build_volume_class_table(vols, scene, cell_size=2.0 * CELL)
    qpos, qn, tri = _surface_points(tables, 20_000, 4)
    ans = find_closest_volume_table(coarse, qpos, tri)
    slack = svr.allowance(qpos, ref["position"], CELL, 1e-3)
    ok = svr.admissible(ans, qpos, qn, ref["position"], ref["normal"], slack)
    assert float((~ok).double().mean()) > 2e-3


def test_the_steps_td_update_and_irradiance(setup, frame):
    """The TD targets from the Q before the step, then each entry's
    running mean in lane order, clamped: within 1e-5 relative of the
    port's one closed-form composition (k updates of an entry round k
    times here and once there; 2.4e-7 seen), the untouched entries and the
    visit counts exactly; the refreshed irradiance column within 1e-6 (the
    same float32 sum).  bfloat16 parts by ~1e-2."""
    _, tables, _, _, ref = setup
    rec = frame[0].records[3]
    st = rec["state"]
    missed, light, _ = _masks(rec, tables)
    _, mat = tables.packed("cpu")
    irr = svr.irradiance(rec["q"], ref["surface_lum"], G)
    pending = st.active & (st.cur_sector >= 0)
    assert torch.equal(pending, rec["pending"]) and bool(pending.any())
    entries = (st.cur_vol * G * G + st.cur_sector)[pending]

    def apply(ft):
        target = svr.td_targets(st.cur_brdf, missed, light,
                                mat[rec["tri"]][:, 10], irr[rec["next_vol"]],
                                0.0, ft)
        return svr.update(rec["q"], rec["visits"], entries, target[pending],
                          RL.radiance_threshold, ft)
    q_ref, v_ref, touched = apply(torch.float32)
    assert _rel_each(rec["q_after"].reshape(-1)[touched],
                     q_ref.reshape(-1)[touched]) <= 1e-5
    untouched = torch.ones(q_ref.numel(), dtype=torch.bool)
    untouched[touched] = False
    assert torch.equal(rec["q_after"].reshape(-1)[untouched],
                       rec["q"].reshape(-1)[untouched])
    assert torch.equal(rec["visits_after"].long(), v_ref)
    assert int((v_ref - rec["visits"].long()).sum()) == int(pending.sum())
    q_low = apply(BF16)[0]
    assert _rel_each(q_low.reshape(-1)[touched],
                     q_ref.reshape(-1)[touched]) > 1e-5
    irr_ref = svr.irradiance(rec["q_after"], ref["surface_lum"], G)
    assert _rel_each(rec["irr"], irr_ref) <= 1e-6
    assert _rel_each(svr.irradiance(rec["q_after"], ref["surface_lum"], G,
                                    BF16), irr_ref) > 1e-6


def test_the_steps_sector_on_shared_uniforms(setup, frame):
    """From the port's CDF rows and uniforms the reference draws the same
    sector on every surface hit (one count of entries below r), the pdf
    within 1e-6 relative; rows in bfloat16 draw other sectors."""
    _, tables, _, _, _ = setup
    rec = frame[0].records[3]
    _, _, surf = _masks(rec, tables)
    rows = rec["cdfplus"][rec["next_vol"], :G * G]
    normal = rec["mrow"][:, 0:3]
    sector, pdf, _ = svr.sample(rows, rec["r"], rec["u"], normal, G)
    assert torch.equal(sector[surf], rec["sector"][surf])
    torch.testing.assert_close(pdf[surf], rec["pdf"][surf], rtol=1e-6,
                               atol=0.0)
    low = svr.sample(rows, rec["r"], rec["u"], normal, G, BF16)[0]
    assert bool((low[surf] != sector[surf]).any())


def test_the_steps_transport(setup, frame):
    """The transport from the port's hits and the reference's sectors:
    every slot's integer state exactly; the banked rows, the survivors'
    throughput, next origin and direction, and the regenerated camera
    rays within 1e-6 relative (the direction's tangent and the camera
    ray are normalised by a division here and by rsqrt there).  bfloat16
    misses that by far."""
    _, tables, _, _, _ = setup
    cap = frame[0]
    rec = cap.records[3]
    st = rec["state"]
    rows = rec["cdfplus"][rec["next_vol"], :G * G]
    sector, pdf, new_d = svr.sample(rows, rec["r"], rec["u"],
                                    rec["mrow"][:, 0:3], G)
    args = (st._asdict(), rec["t"], rec["tri"], rec["mrow"], rec["next_vol"],
            sector, pdf, new_d, rec["u_pix"], tables.n_surfaces,
            common.frame(CONFIG, 2), common.camera(CONFIG), cap.w0, 4)
    ref = svr.transport(*args)
    out = rec["out"]._asdict()
    for k in sff.INTS:
        assert torch.equal(out[k].long(), ref[k].long()), k
    surv, regen = ref["survive"], ref["regen"]
    assert bool(surv.any()) and bool(regen.any())
    for k, m in (("slot_rad", slice(None)), ("tp", surv), ("o", surv),
                 ("d", surv), ("d", regen), ("o", regen),
                 ("cur_brdf", surv)):
        torch.testing.assert_close(out[k][m], ref[k][m], rtol=1e-6,
                                   atol=1e-7)
    low = svr.transport(*args, ft=BF16)
    assert sff._rel_l1(low["tp"][surv], ref["tp"][surv]) > 1e-4


def test_the_frames_rebuild_and_image(frame):
    """The CDF rebuilt from the frame's final Q and the image assembled
    from every flush's banked rows: bit for bit (the same float32 sums in
    the same order; each pixel banked by one slot).  bfloat16 parts by
    more than 1e-3."""
    cap, img, _, vout = frame
    assert cap.q_final is vout.q and cap.cdf is vout.cdf
    cdf = svr.rebuild_cdf(cap.q_final, G)
    assert torch.equal(cap.cdf, cdf)
    assert sff._max_abs(svr.rebuild_cdf(cap.q_final, G, ft=BF16), cdf) > 1e-3
    image = nqr.assemble(cap.flushes, CFG.n_pixels, cap.w0, 2)
    assert torch.equal(img.reshape(-1, 3), image)
    assert sff._rel_l1(nqr.assemble(cap.flushes, CFG.n_pixels, cap.w0, 2,
                                    BF16), image) > 1e-4


@pytest.mark.parametrize("hit_mode, sampler", [("mxu", "row"),
                                               ("mxu", "hier"),
                                               ("f32", "row")])
def test_a_frame_is_the_same_armed_idle_and_off(setup, hit_mode, sampler):
    """Two frames from skewed tables: the images, tables and statistics
    are bit for bit the same with the hook off (None), armed wanting no
    step, and armed (a drawn step and the tail)."""
    scene, _, vols, table, _ = setup
    from rlrpt_tpu_torch.radiance.grid_bucket import build_volume_grid
    grid = table if hit_mode == "mxu" else build_volume_grid(vols)

    def frames(cap):
        sw.CAPTURE = cap
        try:
            v, out = _skewed(vols, 9), []
            for s in (1, 2):
                img, v, aux = sw.render_frame_sarsa_wavefront(
                    s, scene, Camera.create(CAM), v, grid, CFG, RL,
                    pix_mux=4, hit_mode=hit_mode, sampler=sampler,
                    min_drain_w=64)
                out += [img, v.q, v.visits, v.cdf,
                        aux["phase_iterations"], aux["td_scatter_count"],
                        aux["avg_path_length"]]
        finally:
            sw.CAPTURE = None
        return out
    plain = frames(None)
    for cap in (sw.Capture(), sw.Capture(iterations=(2, 5), tail=True)):
        assert all(torch.equal(a, b) for a, b in zip(plain, frames(cap)))
    assert cap.records and cap.flushes


@pytest.mark.parametrize("fault, gap", [("half_td", "visits_gap"),
                                        ("next_vol_shifted", "vol_gap"),
                                        ("cdf_not_rebuilt", "cdf_gap"),
                                        ("image_scaled", "img_gap")])
def test_a_planted_fault_is_caught(setup, fault, gap):
    """Each fault the cell plants (loops/sarsa_fast_frames.py) pushes its
    gap past the cell's limit at this size."""
    import json
    from pathlib import Path
    scene, tables, vols, table, ref = setup
    limits = json.loads((Path(sff.__file__).parents[1] / "traffic"
                         / "sarsa_fast_frames_8spp.json").read_text())[
        "limits"]
    run = types.SimpleNamespace(extra={"faults": {"sarsa": fault},
                                       "sarsa": {"n_volumes":
                                                 vols.n_volumes}})
    cap = sw.Capture(iterations=(3,), tail=True)
    sw.CAPTURE = cap
    try:
        with sff._planted(run, sw):
            img, vout, _ = sff._faulty(sw.render_frame_sarsa_wavefront, run)(
                21, scene, Camera.create(CAM), _skewed(vols, 7), table, CFG,
                RL, pix_mux=4, min_drain_w=64)
    finally:
        sw.CAPTURE = None
    assert sw.rebuild_cdf is rebuild_cdf            # the fault is undone
    rec = dict(cap.records[3], spp=2, w0=cap.w0)
    gaps = sff.step_gaps(rec, ref, tables, (tables.packed("cpu"),
                                             tables.packed("cpu", BF16)),
                         CONFIG, G, torch.as_tensor(svr.class_ids(tables)))
    gaps["cdf_gap"] = sff._max_abs(cap.cdf, svr.rebuild_cdf(cap.q_final, G))
    gaps["img_gap"] = sff._rel_l1(img.reshape(-1, 3), nqr.assemble(
        cap.flushes, CFG.n_pixels, cap.w0, 2))
    assert gaps[gap] > limits[gap], gaps


@pytest.mark.parametrize("fault", [None, "not_carried"])
def test_a_frame_starts_from_the_last_ones_result(setup, fault):
    """Two frames carried as the cell carries them: the second's first
    step reads the Q, visits and CDF rows the first ended with, exactly;
    with the cell's fault ``not_carried`` (the frame returns the volumes
    it was given) it reads the first's starting tables, and ``carry_gap``
    is far past its limit of 0."""
    scene, _, vols, table, _ = setup
    run = types.SimpleNamespace(extra={"faults": {"sarsa": fault}})
    render = sff._faulty(sw.render_frame_sarsa_wavefront, run)
    v, caps = _skewed(vols, 5), []
    for s in (1, 2):
        caps.append(sw.Capture(iterations=(0,)))
        sw.CAPTURE = caps[-1]
        try:
            _, v, _ = render(s, scene, Camera.create(CAM), v, table, CFG, RL,
                             pix_mux=4, min_drain_w=64)
        finally:
            sw.CAPTURE = None
    first, start = caps[0], caps[1].records[0]
    ended = {"q": first.q_final, "visits": first.visits_final,
             "cdf": first.cdf}
    got = {"q": start["q"], "visits": start["visits"],
           "cdf": start["cdfplus"][:, :G * G]}
    gap = max(sff._max_abs(got[k], ended[k]) for k in ended)
    if fault is None:
        assert gap == 0.0
    else:
        assert gap > 1e-3
