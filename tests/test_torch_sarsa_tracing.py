"""The fine-map SARSA loop's own tracing (utils/profiling.py;
integrators/sarsa_wavefront.py) at a tiny size on the CPU: nothing recorded
without a profiler; with one, every stage's span and counters that equal
the frames' own aux; frames, tables and stats bit for bit the same with
tracing on or off and with the capture hook armed or not.  On the card
(``-m chip``), every host wait of a 720x720 8-spp learning frame is one the
program counts, site for site, against torch's sync debug mode, every
step is replayed from a CUDA graph that runs the sector-draw-and-transport
kernel and the lookup and TD kernels once (launched by no wrapper), and
with no profiler nothing records."""

import collections
import types
import warnings
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.integrators import sarsa_wavefront as sw
from rlrpt_tpu_torch.ops import sarsa_td as td_ops
from rlrpt_tpu_torch.radiance.grid_bucket import build_volume_class_table
from rlrpt_tpu_torch.radiance.volumes import build_radiance_volumes
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.utils import profiling
from _torch_parity import (STEP_KERNELS, card, device_kernels,  # noqa: F401
                           ops_outside)

CFG = RenderConfig(width=32, height=32, samples_per_pixel=2,
                   max_ray_bounces=6)
RL = RadianceVolumeConfig(area_per_sample=0.02)
CAM = Camera.create([0.0, 0.0, -3.0])
STAGES = ("hit", "volume", "td", "sample", "transport")
# the spans an op of a frame may lie in: the loop's, its host waits', the
# closest-hit launcher's
SPANS = ("trace_frame_sarsa_wavefront.", "render_frame_sarsa_wavefront.",
         "sync.", "closest_hit_mat_mxu.")


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.RECORDER.reset()
    yield
    profiling.RECORDER.reset()
    sw.CAPTURE = None


@pytest.fixture(scope="module")
def made():
    scene = cornell_box(device="cpu")
    vols = build_radiance_volumes(scene, RL)
    return scene, vols, build_volume_class_table(vols, scene)


def _frames(made, n=2, cfg=CFG, rl=RL, min_drain_w=64):
    """``n`` learning frames from the initial volumes, carried; returns
    (images, the tables after each frame, the frames' aux)."""
    scene, vols, table = made
    imgs, tables, auxes = [], [], []
    for f in range(n):
        img, vols, aux = sw.render_frame_sarsa_wavefront(
            10 + f, scene, CAM, vols, table, cfg, rl, pix_mux=4,
            min_drain_w=min_drain_w)
        imgs.append(img)
        tables += [vols.q, vols.visits, vols.cdf]
        auxes.append(aux)
    return imgs, tables, auxes


def test_nothing_is_recorded_without_a_profiler(made, monkeypatch):
    def no_clock():
        raise AssertionError("a span opened with no profiler")

    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter_ns=no_clock))
    _frames(made, 1)
    rec = profiling.RECORDER
    assert not rec.calls and not rec.ns and not rec.syncs
    assert not rec.counts and not rec.tallies
    assert "trace_frame_sarsa_wavefront.step" not in rec.calls


def test_every_op_of_a_frame_lies_in_a_span(made):
    sw.CAPTURE = cap = sw.Capture(iterations=(1,), tail=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frames(made, 1)
    assert ops_outside(prof, SPANS) == {}
    rec = profiling.RECORDER
    steps = rec.counts["sarsa_wavefront.steps"]
    assert rec.calls["trace_frame_sarsa_wavefront.step"] == steps > 0
    # three copies of each armed step: step 1 and the final phase's
    armed = 1 + sum(1 for r in cap.tail_records if r["step"] != 1)
    assert rec.calls["trace_frame_sarsa_wavefront.capture"] >= 3 * armed
    for name in ("slots", "totals"):
        assert rec.calls[f"trace_frame_sarsa_wavefront.{name}"] == 1
    assert rec.calls["render_frame_sarsa_wavefront.assemble"] == 1
    assert rec.calls["closest_hit_mat_mxu.launch"] == steps
    # the step's stages and copies are its children: its self time leaves
    # them out
    step = "trace_frame_sarsa_wavefront.step"
    assert rec.self_ns[step] == rec.ns[step] - sum(
        rec.ns[f"trace_frame_sarsa_wavefront.{s}"]
        for s in STAGES + ("capture",)) > 0


def test_counters_equal_the_frames_own_aux(made):
    with profile(activities=[ProfilerActivity.CPU]):
        _, _, auxes = _frames(made, 2)
    rec = profiling.RECORDER
    n = rec.tally_values()
    steps = rec.counts["sarsa_wavefront.steps"]
    assert rec.counts["sarsa_wavefront.frames"] == 2
    assert n["sarsa_wavefront.iterations"] == sum(
        int(a["wavefront_iterations"]) for a in auxes)
    assert steps >= n["sarsa_wavefront.iterations"] > 0
    td_rows = sum(int(a["td_scatter_count"]) for a in auxes)
    assert n["sarsa_wavefront.rays"] > td_rows > 0
    for stage in STAGES:
        assert rec.calls[f"trace_frame_sarsa_wavefront.{stage}"] == steps
    assert rec.calls["trace_frame_sarsa_wavefront.pack"] == 2
    assert rec.calls["render_frame_sarsa_wavefront.rebuild"] == 2
    # 256 slots drained to 64: a compaction and two flushes a frame
    assert rec.calls["trace_frame_sarsa_wavefront.compact"] == 2
    assert rec.calls["trace_frame_sarsa_wavefront.flush"] == 4
    assert not rec.syncs                    # host waits count on the card
    # the twins on the CPU, the kernels on the card
    assert rec.counts["sarsa_wavefront.transport_launches"] == 0
    assert rec.counts["sarsa_wavefront.td_kernel_steps"] == 0


def test_frames_are_the_same_traced_and_captured(made):
    plain = _frames(made)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _frames(made)
    sw.CAPTURE = sw.Capture(iterations=(1, 4), tail=True)
    captured = _frames(made)
    cap = sw.CAPTURE
    sw.CAPTURE = sw.Capture()               # armed, wanting no step
    idle = _frames(made)
    sw.CAPTURE = None
    assert set(cap.records) == {1, 4} and cap.tail_records and cap.flushes
    for other in (traced, captured, idle):
        for a, b in zip(plain[0] + plain[1], other[0] + other[1]):
            assert torch.equal(a, b)
        for x, y in zip(plain[2], other[2]):
            for k, v in x.items():
                if isinstance(v, torch.Tensor):
                    assert torch.equal(v, y[k]), k


def test_capture_keeps_the_last_live_steps_of_the_final_phase(made):
    cap = sw.Capture(tail=True)
    sw.CAPTURE = cap
    _, tables, _ = _frames(made, 1)
    sw.CAPTURE = None
    assert 1 <= len(cap.tail_records) <= sw.SYNC_EVERY
    assert [r["step"] for r in cap.tail_records] == list(
        range(cap.steps - len(cap.tail_records), cap.steps))
    assert any(bool(r["live"]) for r in cap.tail_records)
    rec = cap.tail_records[-1]
    assert rec["width"] == 64 and rec["out"].active.shape == (64,)
    assert rec["cdfplus"].shape == (made[1].n_volumes, 145)
    assert torch.equal(cap.cdf, tables[2])
    assert cap.q_final is tables[0]
    assert len(cap.flushes) == 2 and cap.w0 == 256


# the file of each counted host wait (the frame torch names in its warning)
SITE_FILES = {"live_count": "mesh.py", "flush": "sarsa_wavefront.py",
              "camera": "sarsa_wavefront.py",
              "class_ids": "intersect_pallas.py", "bvh_info": "bvh.py"}


@pytest.mark.chip
def test_every_host_wait_of_a_frame_is_counted(card, tmp_path):
    cfg = RenderConfig(width=720, height=720, samples_per_pixel=8,
                       max_ray_bounces=80)
    rl = RadianceVolumeConfig()
    scene = cornell_box(device=card)
    vols = build_radiance_volumes(scene, rl)
    table = build_volume_class_table(vols, scene)
    made = (scene, vols, table)
    _frames(made, 1, cfg, rl, sw.MIN_DRAIN_W)   # every first call
    torch.cuda.synchronize()
    assert not profiling.RECORDER.calls         # no profiler: no record
    profiling.RECORDER.reset()
    launches = [k.launches for k in td_ops.KERNELS]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _, _, auxes = _frames(made, 1, cfg, rl, sw.MIN_DRAIN_W)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    seen = collections.Counter(Path(w.filename).name for w in caught
                               if "synchroniz" in str(w.message))
    rec = profiling.RECORDER
    counted = collections.Counter()
    for site, waits in rec.syncs.items():
        counted[SITE_FILES.get(site, site)] += waits
    print(f"host waits of a frame: torch's sync debug mode {dict(seen)}, "
          f"counted {dict(rec.syncs)}; steps "
          f"{rec.counts['sarsa_wavefront.steps']}, iterations "
          f"{int(auxes[0]['wavefront_iterations'])}")
    assert seen == counted
    assert set(rec.syncs) == set(SITE_FILES)
    # the step's sector draw and transport: one launch, no wait; its
    # lookup and TD update on the kernels, no wait; every step replayed
    # (the first frame captured each width), so no stage span opens and
    # no wrapper launches, but the device runs each kernel once a step
    steps = rec.counts["sarsa_wavefront.steps"]
    assert rec.counts["sarsa_wavefront.transport_launches"] == steps
    assert rec.counts["sarsa_wavefront.td_kernel_steps"] == steps
    assert rec.counts["sarsa_wavefront.graph_steps"] == steps
    for stage in STAGES:
        assert f"trace_frame_sarsa_wavefront.{stage}" not in rec.calls
    assert [k.launches - n for k, n in zip(td_ops.KERNELS, launches)] == [
        0] * len(td_ops.KERNELS)
    ran = device_kernels(prof, tmp_path / "trace.json")
    assert {name: ran[name] for name in STEP_KERNELS} == dict.fromkeys(
        STEP_KERNELS, steps)
    assert rec.syncs["bvh_info"] == rec.syncs["camera"] == 1
    assert rec.syncs["class_ids"] == 1
    # a read every SYNC_EVERY (2) steps of a phase, and its last
    phases = len(auxes[0]["phase_widths"])
    assert rec.syncs["live_count"] == (
        rec.counts["sarsa_wavefront.steps"] // 2 + phases)
    assert rec.syncs["flush"] == 2 * phases
    # the graph route's ops lie in the loop's spans too
    assert ops_outside(prof, SPANS) == {}
    assert rec.calls["trace_frame_sarsa_wavefront.step"] == steps
    assert rec.calls["trace_frame_sarsa_wavefront.replay"] == steps
