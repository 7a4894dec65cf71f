"""The fine-map SARSA loop's graph route (integrators/sarsa_wavefront.py):
on the card, with the answer table, B4a and no mesh, a frame replays each
step from a CUDA graph of its width.

On the CPU: the route's predicate; a CPU frame takes no graph and keeps its
``Capture``; the route's bookkeeping (the static set, the step body, the
record slots and their copies, the tail, the counts, the generator handed
back) with each capture standing in as the plain call it records, against
the kernel route's twins step by step, bit for bit; a patched hook name and
a moved camera captured anew in the same set; the benchmark's reader
``graph_step_pct.sarsa``.  On the card (``-m chip``), graphed 720x720
8-spp frames of ``cornell_720_volumes`` against the eager frames from one
seed: the image, the slot states' integer fields, the visits and the TD
count bit for bit, Q and the irradiance column within the scatter's atomics
(rtol 1e-5), the records field for field; the same under sampler "hier"
with the volumes' frames, and with the camera moved every frame; a patched
``sarsa_contributions`` replayed; a traced frame's steps all replayed, each
of T2-T6 run once a step on the device.
"""

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
from rlrpt_tpu_torch.ops import sarsa_transport as st_ops
from rlrpt_tpu_torch.radiance import grid_bucket as gb
from rlrpt_tpu_torch.radiance.volumes import build_radiance_volumes
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.utils import profiling
from _torch_parity import STEP_KERNELS, card, device_kernels  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CAM = Camera.create([0.0, 0.0, -3.0])
CFG = RenderConfig(width=32, height=32, samples_per_pixel=2,
                   max_ray_bounces=6)
RL = RadianceVolumeConfig(area_per_sample=0.02)
# the records' fields that follow Q, which the card's scatter sums in any
# order: the tables, the irradiance column, the TD targets
Q_FIELDS = ("q", "q_after", "irr", "target", "cdfplus")


@pytest.fixture(autouse=True)
def clean():
    profiling.RECORDER.reset()
    yield
    profiling.RECORDER.reset()
    sw.CAPTURE = None
    sw._GRAPH_SETS.clear()


@pytest.fixture(scope="module")
def made():
    torch.set_num_threads(1)
    scene = cornell_box(device="cpu")
    vols = build_radiance_volumes(scene, RL)
    return scene, vols, gb.build_volume_class_table(vols, scene)


def _frames(made, n, its=(0, 5), cfg=CFG, rl=RL, seed=10, cams=None,
            on_frame=None, **kw):
    """``n`` learning frames from the initial volumes, carried, each armed
    with ``Capture(its, tail=True)``, drawing from a generator of its own
    and seen from ``cams[f]`` (``CAM`` by default), ``on_frame()`` called
    after each; returns [(image, vols, aux, the generator's state after,
    the capture)]."""
    scene, vols, table = made
    out = []
    for f in range(n):
        sw.CAPTURE = cap = sw.Capture(iterations=its, tail=True)
        gen = torch.Generator(device=vols.device).manual_seed(seed + f)
        img, vols, aux = sw.render_frame_sarsa_wavefront(
            gen, scene, CAM if cams is None else cams[f], vols, table, cfg,
            rl, pix_mux=4, **kw)
        out.append((img, vols, aux, gen.get_state(), cap))
        if on_frame is not None:
            on_frame()
    sw.CAPTURE = None
    return out


def _same(a, b, name, loose=False):
    """Two record fields (tensors, slot states or host values): bit for
    bit, or with ``loose`` within the scatter's reordering."""
    if isinstance(a, tuple):
        for field, x, y in zip(sw._SLOT_FIELDS, a, b):
            _same(x, y, f"{name}.{field}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if loose and a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0, msg=name)
        else:
            assert torch.equal(a, b), name
    else:
        assert a == b, name


def _same_frames(eager, graphed, loose=False):
    """Frames and their captures: the image, the slot states, the visits,
    the counts and every record field bit for bit, Q and what follows it
    with ``loose`` within the scatter's reordering."""
    for (ia, va, xa, ga, ca), (ib, vb, xb, gb_, cb) in zip(eager, graphed):
        assert torch.equal(ia, ib)
        assert torch.equal(va.visits, vb.visits)
        _same(va.q, vb.q, "q", loose)
        _same(va.cdf, vb.cdf, "cdf", loose)
        for k, v in xa.items():
            _same(v, xb[k], k)
        assert torch.equal(ga, gb_)     # the generator left where it was
        assert set(ca.records) == set(cb.records) and ca.records
        assert ca.steps == cb.steps and ca.w0 == cb.w0
        assert ([r["step"] for r in ca.tail_records]
                == [r["step"] for r in cb.tail_records])
        recs = list(zip(ca.records.values(), cb.records.values()))
        for ra, rb in recs + list(zip(ca.tail_records, cb.tail_records)):
            assert set(ra) == set(rb)
            for k in ra:
                _same(ra[k], rb[k], k, loose and k in Q_FIELDS)
        assert len(ca.flushes) == len(cb.flushes)
        for fa, fb in zip(ca.flushes, cb.flushes):
            for x, y in zip(fa, fb):
                assert torch.equal(x, y)


# ---- the CPU ----------------------------------------------------------------

@pytest.mark.parametrize("device,grid,hit_mode,mesh,graphed", [
    ("cuda", "table", "mxu", None, True),
    ("cpu", "table", "mxu", None, False),
    ("cuda", "buckets", "mxu", None, False),
    ("cuda", "table", "f32", None, False),
    ("cuda", "table", "mxu", "mesh", False)])
def test_the_graph_route_is_the_cards_kernel_route(made, device, grid,
                                                   hit_mode, mesh, graphed):
    grid = made[2] if grid == "table" else gb.build_volume_grid(made[1])
    args = (torch.device(device), grid, hit_mode, mesh)
    assert sw._graph_route(*args) is graphed
    assert sw._kernel_route(*args) is graphed


def test_a_cpu_frame_takes_no_graph_and_keeps_its_capture(made):
    with profile(activities=[ProfilerActivity.CPU]):
        (_, _, aux, _, cap), = _frames(made, 1)
    rec = profiling.RECORDER
    steps = rec.counts["sarsa_wavefront.steps"]
    assert steps == cap.steps > 0
    assert rec.counts["sarsa_wavefront.graph_steps"] == 0
    assert "trace_frame_sarsa_wavefront.replay" not in rec.calls
    assert rec.calls["trace_frame_sarsa_wavefront.step"] == steps
    assert not sw._GRAPH_SETS
    # the records the eager step keeps: the Capture docstring's fields
    assert set(cap.records) == {0, 5}
    assert set(cap.records[5]) == {
        "step", "phase", "width", "state", "t", "tri", "mrow", "next_vol",
        "q", "visits", "cdfplus", "target", "pending", "q_after",
        "visits_after", "irr", "r", "u", "sector", "pdf", "u_pix", "out",
        "live"}
    assert cap.records[5]["out"] is not cap.records[5]["state"]
    assert [r["step"] for r in cap.tail_records] == [
        cap.steps - 2, cap.steps - 1]


def _as_calls(monkeypatch):
    """The graph route on the CPU, each capture standing in as the plain
    call of what it would record (its replay runs the pair's body)."""
    monkeypatch.setattr(sw, "_kernel_route", lambda *a: True)
    monkeypatch.setattr(sw, "_capture", lambda body, gen=None, gs=None: body)


@pytest.mark.parametrize("sampler,frame_mode", [("row", "hit"),
                                                ("hier", "volume")])
def test_the_graph_routes_bookkeeping_is_the_kernel_routes(
        made, monkeypatch, sampler, frame_mode):
    _as_calls(monkeypatch)
    kw = dict(sampler=sampler, frame_mode=frame_mode, min_drain_w=64)
    monkeypatch.setattr(sw, "_graph_route", lambda *a: False)
    eager = _frames(made, 2, **kw)
    assert not sw._GRAPH_SETS
    monkeypatch.setattr(sw, "_graph_route", lambda *a: True)
    with profile(activities=[ProfilerActivity.CPU]):
        graphed = _frames(made, 2, **kw)
    _same_frames(eager, graphed)
    rec = profiling.RECORDER
    steps = rec.counts["sarsa_wavefront.steps"]
    assert steps == sum(f[4].steps for f in graphed)
    # the first frame runs each of its 2 widths' first step op by op
    assert rec.counts["sarsa_wavefront.graph_steps"] == steps - 2
    assert rec.calls["trace_frame_sarsa_wavefront.replay"] == steps - 2
    assert rec.tally_values()["sarsa_wavefront.iterations"] == sum(
        int(f[2]["wavefront_iterations"]) for f in graphed)
    (gs,) = sw._GRAPH_SETS.values()
    assert sorted(gs.states) == [64, 256]
    assert sorted(gs.graphs) == [64, 256]
    # armed: each width's SYNC_EVERY record slots and their copies
    assert [len(g.copies) for g in gs.graphs.values()] == [2, 2]
    # what a frame returns is its own
    assert graphed[0][1].q.data_ptr() != gs.td.q.data_ptr()


def test_a_patched_hook_name_is_captured_anew(made, monkeypatch):
    _as_calls(monkeypatch)
    sound = sw.sarsa_contributions

    def broken(vol_idx, sector, target, mask, v, s, scratch=None):
        keep = torch.arange(mask.shape[0], device=mask.device) % 2 == 0
        return sound(vol_idx, sector, target, mask & keep, v, s, scratch)
    kw = dict(min_drain_w=64)
    sound_frame = _frames(made, 1, **kw)
    monkeypatch.setattr(sw, "sarsa_contributions", broken)
    monkeypatch.setattr(sw, "_graph_route", lambda *a: False)
    eager = _frames(made, 1, **kw)
    monkeypatch.setattr(sw, "_graph_route", lambda *a: True)
    graphed = _frames(made, 1, **kw)
    _same_frames(eager, graphed)
    assert not torch.equal(graphed[0][1].visits, sound_frame[0][1].visits)
    (gs,) = sw._GRAPH_SETS.values()
    hook = sw._STEP_NAMES.index("sarsa_contributions")
    assert gs.held[1][hook] is broken


def test_a_moved_camera_is_captured_anew_in_the_same_set(made, monkeypatch):
    _as_calls(monkeypatch)
    kw = dict(min_drain_w=64)
    cams = [CAM, CAM.rotate_left(0.05).move_forwards(0.02), CAM]
    monkeypatch.setattr(sw, "_graph_route", lambda *a: False)
    eager = _frames(made, 3, cams=cams, **kw)
    monkeypatch.setattr(sw, "_graph_route", lambda *a: True)
    sets = []
    with profile(activities=[ProfilerActivity.CPU]):
        graphed = _frames(made, 3, cams=cams, on_frame=lambda: sets.extend(
            sw._GRAPH_SETS.values()), **kw)
    _same_frames(eager, graphed)
    assert len(set(map(id, sets))) == 1     # one set, its tables kept
    rec = profiling.RECORDER
    # each frame captures its 2 widths anew: the camera changed each time
    assert rec.counts["sarsa_wavefront.graph_steps"] == (
        rec.counts["sarsa_wavefront.steps"] - 2 * len(cams))
    assert sets[0].held[0] == CAM


@pytest.mark.parametrize("counts,value", [
    ({"sarsa_wavefront.steps": 540,
      "sarsa_wavefront.graph_steps": 540}, 100.0),
    ({"sarsa_wavefront.steps": 540,
      "sarsa_wavefront.graph_steps": 532}, 100.0 * 532 / 540),
    ({"sarsa_wavefront.steps": 540}, None),     # a program without the count
    ({}, None)])
def test_graph_step_pct_reads_the_counts(counts, value):
    read = harness.load_module(
        ROOT / "benchmark" / "metrics" / "graph_step_pct.sarsa.py",
        "metric_graph_step_pct_sarsa").read
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

CELL_CFG = RenderConfig(width=720, height=720, samples_per_pixel=8,
                        max_ray_bounces=80)
CELL_RL = RadianceVolumeConfig()       # 24,526 volumes at 12x12 sectors


@pytest.fixture(scope="module")
def cell(card):
    """``cornell_720_volumes`` on the card: the scene, the initial volumes
    and the answer table."""
    scene = cornell_box(device=card)
    vols = build_radiance_volumes(scene, CELL_RL)
    return scene, vols, gb.build_volume_class_table(vols, scene)


def _cell_frames(cell, n, its=(0, 7), seed=10, **kw):
    return _frames(cell, n, its, CELL_CFG, CELL_RL, seed, **kw)


@pytest.mark.chip
@pytest.mark.parametrize("kw,moves", [
    ({}, 1), (dict(sampler="hier", frame_mode="volume"), 1), ({}, 3)],
    ids=("row", "hier-volume", "moving"))
def test_a_graphed_frame_is_the_eager_frame_on_the_card(
        cell, monkeypatch, kw, moves):
    # a moving camera: each frame from the initial volumes, captured anew
    cams = [CAM] + [CAM.rotate_left(0.05 * f).move_forwards(0.02 * f)
                    for f in range(1, moves)]
    if moves == 1:
        _cell_frames(cell, 1, seed=3, **kw)     # every width captured
    graphed = [_cell_frames(cell, 1, cams=[c], **kw)[0] for c in cams]
    monkeypatch.setattr(sw, "_graph_route", lambda *a: False)
    eager = [_cell_frames(cell, 1, cams=[c], **kw)[0] for c in cams]
    _same_frames(eager, graphed, loose=True)
    cap = graphed[-1][4]
    assert cap.records[0]["width"] == cap.records[7]["width"] == 129600
    assert cap.tail_records[-1]["width"] == 2025


@pytest.mark.chip
def test_a_patched_sarsa_contributions_is_replayed_on_the_card(
        cell, monkeypatch):
    sound = sw.sarsa_contributions

    def broken(vol_idx, sector, target, mask, v, s, scratch=None):
        keep = torch.arange(mask.shape[0], device=mask.device) % 2 == 0
        return sound(vol_idx, sector, target, mask & keep, v, s, scratch)
    monkeypatch.setattr(sw, "sarsa_contributions", broken)
    _cell_frames(cell, 1, seed=3)      # the patch captured
    with profile(activities=[ProfilerActivity.CPU]):
        graphed = _cell_frames(cell, 1)
    rec = profiling.RECORDER
    assert (rec.counts["sarsa_wavefront.graph_steps"]
            == rec.counts["sarsa_wavefront.steps"] > 0)
    monkeypatch.setattr(sw, "_graph_route", lambda *a: False)
    eager = _cell_frames(cell, 1)
    _same_frames(eager, graphed, loose=True)
    monkeypatch.setattr(sw, "sarsa_contributions", sound)
    sound_frame = _cell_frames(cell, 1)
    assert not torch.equal(graphed[0][1].visits, sound_frame[0][1].visits)


@pytest.mark.chip
def test_a_traced_card_frame_replays_every_step(cell, tmp_path):
    _cell_frames(cell, 1, seed=3)
    torch.cuda.synchronize()
    profiling.RECORDER.reset()
    kernels = (st_ops.KERNEL,) + td_ops.KERNELS
    launches = [k.launches for k in kernels]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (_, _, aux, _, cap), = _cell_frames(cell, 1)
        torch.cuda.synchronize()
    rec = profiling.RECORDER
    steps = rec.counts["sarsa_wavefront.steps"]
    assert steps == cap.steps > 0
    assert rec.counts["sarsa_wavefront.graph_steps"] == steps
    assert rec.counts["sarsa_wavefront.transport_launches"] == steps
    assert rec.counts["sarsa_wavefront.td_kernel_steps"] == steps
    assert rec.calls["trace_frame_sarsa_wavefront.replay"] == steps
    assert "trace_frame_sarsa_wavefront.hit" not in rec.calls
    # a replay is no launch of the wrappers, but runs each kernel once
    assert [k.launches for k in kernels] == launches
    ran = device_kernels(prof, tmp_path / "trace.json")
    assert {name: ran[name] for name in STEP_KERNELS} == dict.fromkeys(
        STEP_KERNELS, steps)
    assert rec.tally_values()["sarsa_wavefront.iterations"] == int(
        aux["wavefront_iterations"])
    print(f"a graphed frame: {steps} steps, phases "
          f"{aux['phase_iterations'].tolist()} at widths "
          f"{list(aux['phase_widths'])}")
