"""The fine-map SARSA wavefront's nearest-volume lookup and TD update
kernels (ops/sarsa_td.py, csrc/sarsa_td.cu).

On the CPU: the wrappers run the plain twins; ``targets_plain`` is the
frame's former torch code of the targets (``_former_td`` below, kept as it
was), and the kernel route's twins (targets, scatter into a scratch kept
zero, apply and irradiance refresh of the dirty rows) give what the former
whole-table code gives (radiance/volumes.py), with duplicate entries,
masked lanes, entries clamped at the threshold and bf16 rows; the scratch
is zero after a step and untouched entries keep their bits; the frame's
two hook names (the benchmark's planted faults) reach the step; the
wrappers refuse what the kernels do not take; the benchmark's reader
``td_kernel_pct.sarsa`` reads the counts.  On the card (``-m chip``): the
lookup, the targets and the apply (with the irradiance refresh) bit for
bit their twins run on the card at the fine-map cell's phase widths; after
a real scatter the visits are exact and Q within the atomics' reordering
(rtol 1e-5, far under the cell's q_gap limit 1e-4), and the refreshed
column equals irradiance_estimates of the kernels' Q bit for bit, the rows
no lane touched included.
"""

import dataclasses
import math
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.integrators import sarsa_wavefront as sw
from rlrpt_tpu_torch.ops import sarsa_td as td_ops
from rlrpt_tpu_torch.ops.hemisphere import sector_cos_thetas
from rlrpt_tpu_torch.radiance import grid_bucket as gb
from rlrpt_tpu_torch.radiance import volumes as rv
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.utils import profiling
from _torch_parity import card  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
THR, ENV = 0.8 / 144, 0.25


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.RECORDER.reset()
    yield
    profiling.RECORDER.reset()


def _case(wp, gr, n_vol, *, bf16=False, hot=0.3, live=0.85, seed=0,
          device="cpu"):
    """A step's TD inputs, made on the CPU and moved to ``device``:
    (volumes, carried rows, slot state, missed, light, the luminance as a
    column of a material row, next volumes).  A ``hot`` share of the lanes
    aims at a few entries (duplicates); some entries sit at the threshold
    and their targets are 0 (clamped)."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=g)  # noqa: E731
    ints = lambda hi, n: torch.randint(0, hi, (n,), generator=g)  # noqa: E731
    s = gr * gr
    q = rand(n_vol, s) * 2.0 + THR
    q[rand(n_vol, s) < 0.2] = THR
    visits = torch.randint(0, 40, (n_vol, s), generator=g).int()
    w = torch.relu(rand(n_vol, s) * 4 - 1) + 1e-3
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), dim=-1)
    vols = rv.RadianceVolumes(
        position=rand(n_vol, 3), normal=torch.eye(3)[ints(3, n_vol)],
        frame=torch.eye(3).expand(n_vol, 3, 3).contiguous(),
        surface_lum=rand(n_vol), q=q, visits=visits, cdf=cdf,
        grid_resolution=gr)
    cur_vol = ints(n_vol, wp)
    cur_sector = ints(s, wp) - (rand(wp) < 0.2).long()
    hot_lane = rand(wp) < hot
    cur_vol = torch.where(hot_lane, ints(3, wp), cur_vol)
    cur_sector = torch.where(hot_lane, ints(2, wp), cur_sector)
    active = rand(wp) < live
    missed = active & (rand(wp) < 0.1)
    light = active & ~missed & (rand(wp) < 0.1)
    cur_brdf = rand(wp)
    # lanes on the threshold entries that bring a target of 0
    zero = rand(wp) < 0.05
    cur_brdf = torch.where(zero, 0.0, cur_brdf)
    mrow = rand(wp, 16)
    state = types.SimpleNamespace(active=active, cur_sector=cur_sector,
                                  cur_vol=cur_vol, cur_brdf=cur_brdf)
    next_vol = ints(n_vol, wp)
    to = lambda a: a.to(device)  # noqa: E731
    vols = rv.RadianceVolumes(*(to(getattr(vols, f.name))
                                if f.name != "grid_resolution" else gr
                                for f in dataclasses.fields(vols)))
    state = types.SimpleNamespace(**{k: to(a) for k, a in
                                     vars(state).items()})
    mrow = to(mrow)
    # the column as the frame makes it, on the volumes' device
    cdfplus = torch.cat([vols.cdf, rv.irradiance_estimates(vols)[:, None]], 1)
    cdfplus = cdfplus.to(torch.bfloat16 if bf16 else torch.float32)
    return (vols, cdfplus, state, to(missed), to(light), mrow[:, 10],
            to(next_vol))


def _former_td(vols, cdfplus, c, missed, light, lum, next_vol, mask=None):
    """The frame's ``.volume`` bootstrap gather and ``.td`` stage as they
    were before the kernels took them over: (target, pending, vols after,
    the irradiance column, the TD count)."""
    v, s = vols.n_volumes, vols.n_sectors
    cos = sector_cos_thetas(vols.grid_resolution, vols.device)
    irr_b = cdfplus[next_vol, -1].float()
    target = torch.where(
        missed, c.cur_brdf * ENV,
        torch.where(light, c.cur_brdf * lum, c.cur_brdf * irr_b))
    pending = c.active & (c.cur_sector >= 0)
    scratch = rv.td_scratch(v, s, vols.device)
    sum_t, cnt = rv.sarsa_contributions(
        c.cur_vol, torch.clamp(c.cur_sector, min=0), target,
        pending if mask is None else mask, v, s, scratch)
    after = rv.apply_sarsa_contributions(vols, sum_t, cnt, THR)
    irr = rv.irradiance_estimates(after, cos).to(cdfplus.dtype)
    return target, pending, after, irr, pending.sum()


def _kernel_route(vols, cdfplus, c, missed, light, lum, next_vol,
                  keep=None):
    """The frame's kernel route through the wrappers: (the TdFrame after
    the step, target, pending); ``keep`` drops lanes from the scatter's
    mask, as the planted fault ``half_td`` does."""
    cos = sector_cos_thetas(vols.grid_resolution, vols.device)
    td = td_ops.td_frame(vols, cdfplus.clone(), cos, THR, ENV)
    target, pending = td_ops.td_targets(td, c, missed, light, lum, next_vol)
    mask = pending if keep is None else pending & keep
    td_ops.sarsa_contributions(c.cur_vol, c.cur_sector, target, mask,
                               vols.n_volumes, vols.n_sectors, td.scratch)
    td_ops.apply_refresh(td)
    return td, target, pending


def _assert_zero_scratch(td):
    sc = td.scratch
    assert not sc.sum_t.any() and not sc.cnt.any() and not sc.dirty.any()


CPU_CASES = {
    "4x4 sectors": dict(wp=400, gr=4, n_vol=30),
    "12x12 sectors": dict(wp=900, gr=12, n_vol=40, seed=1),
    "12x12, bf16 rows": dict(wp=900, gr=12, n_vol=40, bf16=True, seed=2),
    "11x11, all hot": dict(wp=500, gr=11, n_vol=20, hot=1.0, seed=3),
    "none live": dict(wp=100, gr=4, n_vol=10, live=0.0, seed=4),
}


@pytest.mark.parametrize("name", list(CPU_CASES))
def test_the_kernel_routes_twins_are_the_former_whole_table_code(name):
    vols, cdfplus, c, missed, light, lum, nv = _case(**CPU_CASES[name])
    q0, visits0 = vols.q.clone(), vols.visits.clone()
    target, pending, after, irr, count = _former_td(
        vols, cdfplus, c, missed, light, lum, nv)
    launches = [k.launches for k in td_ops.KERNELS]
    td, t_got, p_got = _kernel_route(vols, cdfplus, c, missed, light, lum,
                                     nv)
    assert [k.launches for k in td_ops.KERNELS] == launches
    assert torch.equal(t_got, target) and torch.equal(p_got, pending)
    assert torch.equal(td.q, after.q) and torch.equal(td.visits,
                                                      after.visits)
    assert torch.equal(td.cdfplus[:, -1], irr)
    assert torch.equal(td.cdfplus[:, :-1], cdfplus[:, :-1])
    assert torch.equal(td.count, count)
    _assert_zero_scratch(td)
    # the caller's tables are not written; untouched entries keep their bits
    assert torch.equal(vols.q, q0) and torch.equal(vols.visits, visits0)
    s = vols.n_sectors
    touched = torch.zeros(vols.q.numel(), dtype=torch.bool)
    touched[(c.cur_vol * s + c.cur_sector.clamp(min=0))[pending]] = True
    assert torch.equal(td.q.reshape(-1)[~touched], q0.reshape(-1)[~touched])
    assert torch.equal(td.visits.reshape(-1)[~touched],
                       visits0.reshape(-1)[~touched])
    if bool(pending.any()):
        # duplicates, and the threshold's clamp, were exercised
        assert int(td.visits.sum() - visits0.sum()) == int(count)
        assert (td.visits - visits0).max() > 1
    if CPU_CASES[name].get("hot", 0.3) < 1 and bool(pending.any()):
        assert bool((td.q.reshape(-1)[touched] == THR).any())


def test_dropped_lanes_leave_their_entries_alone():
    """The planted fault ``half_td`` drops every second lane from the
    scatter's mask: the apply finds no count on the entries only those
    lanes aimed at and leaves them as they were."""
    vols, cdfplus, c, missed, light, lum, nv = _case(600, 12, 30, seed=5)
    keep = torch.arange(600) % 2 == 0
    pending = c.active & (c.cur_sector >= 0)
    _, _, after, irr, _ = _former_td(vols, cdfplus, c, missed, light, lum,
                                     nv, mask=pending & keep)
    td, _, _ = _kernel_route(vols, cdfplus, c, missed, light, lum, nv,
                             keep=keep)
    assert torch.equal(td.q, after.q) and torch.equal(td.visits,
                                                      after.visits)
    assert torch.equal(td.cdfplus[:, -1], irr)
    _assert_zero_scratch(td)
    full, _, _ = _kernel_route(vols, cdfplus, c, missed, light, lum, nv)
    assert not torch.equal(td.visits, full.visits)


def test_the_lookup_wrapper_is_the_table_query_on_the_cpu():
    scene = cornell_box(device="cpu")
    vols = rv.build_radiance_volumes(
        scene, RadianceVolumeConfig(area_per_sample=0.02))
    tb = gb.build_volume_class_table(vols, scene)
    g = torch.Generator().manual_seed(0)
    qpos = vols.position[torch.randint(0, vols.n_volumes, (500,),
                                       generator=g)]
    qpos = qpos + 0.02 * torch.randn((500, 3), generator=g)
    tri = torch.randint(0, scene.n_surfaces, (500,), generator=g)
    cls = tb.tri_class[tri]
    for kw in ({}, {"cls": cls}):
        assert torch.equal(td_ops.find_closest_volume_table(tb, qpos, tri,
                                                            **kw),
                           gb.find_closest_volume_table(tb, qpos, tri, **kw))


def test_the_frame_binds_the_hook_names_to_the_wrappers():
    assert sw.sarsa_contributions is td_ops.sarsa_contributions
    assert sw.find_closest_volume_table is td_ops.find_closest_volume_table


CFG = RenderConfig(width=16, height=16, samples_per_pixel=2,
                   max_ray_bounces=5)
RL = RadianceVolumeConfig(area_per_sample=0.05)


@pytest.fixture(scope="module")
def small_scene():
    scene = cornell_box(device="cpu")
    vols = rv.build_radiance_volumes(scene, RL)
    return scene, vols, gb.build_volume_class_table(vols, scene)


def _frame(made):
    scene, vols, table = made
    _, out, aux = sw.render_frame_sarsa_wavefront(
        10, scene, Camera.create([0.0, 0.0, -3.0]), vols, table, CFG, RL,
        pix_mux=4, min_drain_w=16)
    return out, aux


@pytest.mark.parametrize("fault", ["half_td", "next_vol_shifted"])
def test_patching_a_hook_name_changes_the_frame(small_scene, fault,
                                                monkeypatch):
    """The benchmark's planted faults patch these module names, with
    these signatures, and the step calls them through the module."""
    sound_vols, sound_aux = _frame(small_scene)
    n_vol = small_scene[1].n_volumes
    if fault == "half_td":
        sound = sw.sarsa_contributions

        def broken(vol_idx, sector, target, mask, v, s, scratch=None):
            keep = torch.arange(mask.shape[0]) % 2 == 0
            return sound(vol_idx, sector, target, mask & keep, v, s,
                         scratch)
        monkeypatch.setattr(sw, "sarsa_contributions", broken)
    else:
        sound = sw.find_closest_volume_table

        def broken(tb, qpos, tri, cls=None):
            return (sound(tb, qpos, tri, cls=cls) + 1) % n_vol
        monkeypatch.setattr(sw, "find_closest_volume_table", broken)
    vols, aux = _frame(small_scene)
    assert not torch.equal(vols.visits, sound_vols.visits)
    # the visits count the updates applied (from none); the TD count the
    # pending lanes, which the dropped lanes stay among
    assert int(sound_vols.visits.sum()) == int(sound_aux["td_scatter_count"])
    if fault == "half_td":
        assert int(vols.visits.sum()) < int(aux["td_scatter_count"])


def _bad(name):
    vols, cdfplus, c, missed, light, lum, nv = _case(40, 4, 10, seed=6)
    cos = sector_cos_thetas(4, "cpu")
    if name == "q dtype":
        vols = dataclasses.replace(vols, q=vols.q.double())
        return lambda: td_ops.td_frame(vols, cdfplus, cos, THR, ENV), \
            "q must be torch.float32"
    if name == "rows dtype":
        return lambda: td_ops.td_frame(vols, cdfplus.double(), cos, THR,
                                       ENV), "cdfplus must be"
    if name == "rows shape":
        return lambda: td_ops.td_frame(vols, cdfplus[:, :-1].contiguous(),
                                       cos, THR, ENV), "cdfplus must be"
    td = td_ops.td_frame(vols, cdfplus, cos, THR, ENV)
    if name == "brdf dtype":
        c.cur_brdf = c.cur_brdf.double()
        return lambda: td_ops.td_targets(td, c, missed, light, lum, nv), \
            "cur_brdf must be"
    if name == "next_vol dtype":
        return lambda: td_ops.td_targets(td, c, missed, light, lum,
                                         nv.int()), "next_vol must be"
    if name == "lum dtype":
        return lambda: td_ops.td_targets(td, c, missed, light,
                                         lum.double(), nv), "lum must be"
    if name == "mask dtype":
        return lambda: td_ops.sarsa_contributions(
            c.cur_vol, c.cur_sector, c.cur_brdf, c.active.int(), 10, 16,
            td.scratch), "mask must be"
    if name == "scratch shape":
        return lambda: td_ops.sarsa_contributions(
            c.cur_vol, c.cur_sector, c.cur_brdf, c.active, 10, 9,
            td.scratch), "the scratch is not"
    raise AssertionError(name)


@pytest.mark.parametrize("name", [
    "q dtype", "rows dtype", "rows shape", "brdf dtype", "next_vol dtype",
    "lum dtype", "mask dtype", "scratch shape"])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(name):
    call, msg = _bad(name)
    with pytest.raises(ValueError, match=msg):
        call()


def test_a_cpu_frame_takes_no_kernel(small_scene):
    with profile(activities=[ProfilerActivity.CPU]):
        _frame(small_scene)
    rec = profiling.RECORDER
    assert rec.counts["sarsa_wavefront.steps"] > 0
    assert rec.counts["sarsa_wavefront.td_kernel_steps"] == 0


@pytest.mark.parametrize("counts,value", [
    ({"sarsa_wavefront.steps": 540,
      "sarsa_wavefront.td_kernel_steps": 540}, 100.0),
    ({"sarsa_wavefront.steps": 540,
      "sarsa_wavefront.td_kernel_steps": 135}, 25.0),
    ({"sarsa_wavefront.steps": 540}, None),     # a program without the count
    ({}, None)])
def test_td_kernel_pct_reads_the_counts(counts, value):
    read = harness.load_module(
        ROOT / "benchmark" / "metrics" / "td_kernel_pct.sarsa.py",
        "metric_td_kernel_pct_sarsa").read
    rec = profiling.RECORDER
    rec.calls["trace_frame_sarsa_wavefront.pack"] = 2
    rec.counts.update(counts)
    run = types.SimpleNamespace(
        traffic={"loop": "progressive"}, traced_answers=2,
        extra={"sarsa": {}}, trace_summary={"window_s": 4.0, "busy_s": 0.4})
    assert read(run) == value
    assert read(types.SimpleNamespace(**dict(vars(run), extra={}))) is None
    assert read(types.SimpleNamespace(
        **dict(vars(run), trace_summary=None))) is None


# ---- the card ---------------------------------------------------------------

# the fine-map cell's phases: 720x720 at 4 pixels a slot, 12x12 sectors,
# 24,526 volumes
CELL = dict(gr=12, n_vol=24526)
WIDTHS = (129600, 32400, 8100, 2025)
CARD_CASES = {
    "129600 lanes": dict(wp=129600, **CELL),
    "32400 lanes, bf16 rows": dict(wp=32400, bf16=True, seed=1, **CELL),
    "8100 lanes": dict(wp=8100, seed=2, **CELL),
    "2025 lanes, bf16 rows": dict(wp=2025, bf16=True, seed=3, **CELL),
    "11x11 sectors": dict(wp=8100, gr=11, n_vol=5000, seed=4),
    "8x8 sectors, all hot": dict(wp=3000, gr=8, n_vol=300, hot=1.0, seed=5),
    "none live": dict(wp=1000, live=0.0, seed=6, **CELL),
}


@pytest.fixture(scope="module")
def card_table(card):
    scene = cornell_box(device=card)
    vols = rv.build_radiance_volumes(
        scene, RadianceVolumeConfig(area_per_sample=0.004))
    return scene, vols, gb.build_volume_class_table(vols, scene)


@pytest.mark.chip
def test_the_lookup_is_the_table_query_on_the_card(card, card_table):
    scene, vols, tb = card_table
    g = torch.Generator().manual_seed(7)
    n = 129600
    near = vols.position.cpu()[torch.randint(0, vols.n_volumes, (n,),
                                             generator=g)]
    near = near + 0.03 * torch.randn((n, 3), generator=g)
    box = torch.rand((n, 3), generator=g) * 2.4 - 1.2
    qpos = torch.where(torch.rand((n, 1), generator=g) < 0.7, near, box)
    qpos[:50] = torch.tensor([50.0, -50.0, 3e38])
    qpos[50:60] = float("inf")
    tri = torch.randint(0, scene.n_surfaces, (n,), generator=g)
    cls = tb.tri_class.cpu()[tri]
    cls[torch.rand(n, generator=g) < 0.1] = 9999     # a class no slot has
    qpos, tri, cls = qpos.to(card), tri.to(card), cls.to(card)
    for m in (n, 2025, 1):
        launches = td_ops.KERNEL_LOOKUP.launches
        got = td_ops.find_closest_volume_table(tb, qpos[:m], tri[:m],
                                               cls=cls[:m])
        ref = gb.find_closest_volume_table(tb, qpos[:m], tri[:m],
                                           cls=cls[:m])
        assert td_ops.KERNEL_LOOKUP.launches == launches + 1
        assert got.dtype == torch.int64 and torch.equal(got, ref)


def _twins_on(td):
    """A copy of ``td`` (tables and scratch) for the twin to run on."""
    sc = td.scratch
    scratch = td_ops.zero_scratch(*td.q.shape, td.q.device)
    for a, b in zip(scratch[:3], sc[:3]):
        a.copy_(b)
    return dataclasses.replace(td, q=td.q.clone(), visits=td.visits.clone(),
                               cdfplus=td.cdfplus.clone(), scratch=scratch,
                               count=td.count.clone(), checked=set())


@pytest.mark.chip
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_the_kernels_are_their_twins_on_the_card(card, name):
    kw = CARD_CASES[name]
    vols, cdfplus, c, missed, light, lum, nv = _case(**kw, device=card)
    cos = sector_cos_thetas(vols.grid_resolution, card)
    td = td_ops.td_frame(vols, cdfplus.clone(), cos, THR, ENV)
    twin = _twins_on(td)
    launches = [k.launches for k in td_ops.KERNELS]
    # the targets, bit for bit
    got = td_ops.td_targets(td, c, missed, light, lum, nv)
    ref = td_ops.targets_plain(c, missed, light, lum, nv, twin.cdfplus, ENV)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(td.count) == int(ref[1].sum())
    # one scatter (the twin's index_add_), copied to both sides, then the
    # apply and refresh, bit for bit
    td_ops.scatter_plain(c.cur_vol, c.cur_sector, ref[0], ref[1],
                         vols.n_sectors, td.scratch)
    for a, b in zip(twin.scratch[:3], td.scratch[:3]):
        a.copy_(b)
    td_ops.apply_refresh(td)
    td_ops.apply_plain(twin)
    torch.cuda.synchronize()
    for name_ in ("q", "visits", "cdfplus"):
        assert torch.equal(getattr(td, name_), getattr(twin, name_)), name_
    _assert_zero_scratch(td)
    assert [k.launches for k in td_ops.KERNELS] == [
        launches[0], launches[1] + 1, launches[2], launches[3] + 1]


@pytest.mark.chip
@pytest.mark.parametrize("wp", WIDTHS)
def test_a_step_on_the_kernels_against_the_former_code(card, wp):
    """A whole step's update on the kernels against the former torch code
    on the card: the visits exact, Q within the atomics' order, and the
    column the irradiance of the kernels' own Q, every row's bit for
    bit."""
    vols, cdfplus, c, missed, light, lum, nv = _case(
        wp, seed=wp, device=card, **CELL)
    target, pending, after, irr, count = _former_td(
        vols, cdfplus, c, missed, light, lum, nv)
    launches = td_ops.KERNEL_SCATTER.launches
    td, t_got, p_got = _kernel_route(vols, cdfplus, c, missed, light, lum,
                                     nv)
    torch.cuda.synchronize()
    assert td_ops.KERNEL_SCATTER.launches == launches + 1
    assert torch.equal(t_got, target) and torch.equal(p_got, pending)
    assert torch.equal(td.count, count)
    assert torch.equal(td.visits, after.visits)
    torch.testing.assert_close(td.q, after.q, rtol=1e-5, atol=0)
    own = rv.irradiance_estimates(dataclasses.replace(vols, q=td.q),
                                  sector_cos_thetas(12, card))
    assert torch.equal(td.cdfplus[:, -1], own)
    torch.testing.assert_close(td.cdfplus[:, -1], irr, rtol=1e-5, atol=0)
    _assert_zero_scratch(td)
    untouched = after.visits == vols.visits
    assert torch.equal(td.q[untouched], vols.q[untouched])
