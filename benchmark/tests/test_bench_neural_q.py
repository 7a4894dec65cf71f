"""The deep-Q cell ``cornell_neural_q_1spp`` on the CPU at a tiny size: the
harness finds its files by name; a sound run is correct and the control
(the reference in bfloat16) is not; each fault planted in the timed path
turns ``correct`` false; the MLP's and B4a's counts from shapes; the
capture hook leaves the frames as they were; the new metrics read None
where a run has nothing to read.  The card's half runs the cell itself
(``-m chip``)."""

import json
import subprocess
import sys
import time
import types

import pytest
import torch

from benchmark import harness, roofline, roofline_deep, tracing
from benchmark.tests.small import ROOT, spec

CELL = "cornell_neural_q_1spp"
TINY = {"config": {"width": 24, "height": 24, "max_ray_bounces": 6,
                   "gt": None, "deep": {"batch_size": 64}},
        "traffic": {"spp": 2}}
METRICS = ("mfu.deep", "b4a_roofline", "kernels_per_iter.deep",
           "train_host_ms.deep", "host_syncs.deep")
TRACED = ("device_idle.render",) + METRICS   # the cell's traced metrics


def run_cell(seconds=0.3, trace=False, **kw):
    s = spec()
    return harness.execute(ROOT, s, harness.find_cell(s, CELL), 2 ** 33 + 9,
                           seconds, trace, "cpu", time.perf_counter(),
                           overrides=TINY, **kw)


def test_the_harness_finds_the_cell():
    s = spec()
    cell = harness.find_cell(s, CELL)
    assert cell["chips"] == 1 and cell["config"] == "cornell_720_dqn"
    config, traffic = harness.cell_files(s, cell)
    assert config["name"] == "cornell_720_dqn" and config["reduced"] == []
    assert traffic["loop"] == "neural_q_frames"
    assert (ROOT / "benchmark/loops/neural_q_frames.py").is_file()
    assert (ROOT / f"benchmark/scenes/{config['scene']['kind']}.py").is_file()
    d = config["deep"]
    assert (d["input_width"], *d["hidden_sizes"], d["n_actions"]) == \
        roofline_deep.WIDTHS
    assert d["sector_grid"] ** 2 == d["n_actions"]
    assert [m["name"] for m in harness.metrics_for(s, CELL, False)] == [
        "paths_per_s", "setup_s"]
    traced = [m["name"] for m in harness.metrics_for(s, CELL, True)]
    assert traced == list(TRACED)
    for m in harness.metrics_for(s, CELL, True):
        assert m["moves"] == "paths_per_s"
        mod = harness.load_module(
            ROOT / "benchmark" / "metrics" / f"{m['name']}.py", "m")
        assert callable(mod.read)


def test_a_sound_run_is_correct_and_the_control_is_not():
    r = run_cell(control=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1
    assert set(r["metrics"]) == {"paths_per_s", "setup_s"}
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert set(limits) == {"hit_gap", "q_gap", "sector_gap", "td_gap",
                           "train_gap", "rad_gap", "img_gap"}
    failed = [k for k, v in r["control"].items() if v > limits[k]]
    assert failed, r["control"]
    json.dumps(r)


@pytest.mark.parametrize("fault, gap", [("not_trained", "train_gap"),
                                        ("half_minibatches", "train_gap"),
                                        ("image_scaled", "img_gap"),
                                        ("hit_far", "hit_gap"),
                                        ("wrong_triangle", "hit_gap")])
def test_a_planted_fault_makes_the_run_incorrect(fault, gap):
    r = run_cell(faults={"deep": fault})
    assert not r["correct"], r["checks"]
    assert r["checks"][gap]["value"] > r["checks"][gap]["limit"]


def test_the_drawn_iteration_trains_every_minibatch_of_the_widest_phase():
    """At 96x96 the frame drains 2,304 slots to 576: the drawn iteration
    is one of the 2,304-wide phase's, so a fault that skips every second
    of its 9 minibatches shows even where the last phase trains one."""
    size = {"config": {"width": 96, "height": 96, "max_ray_bounces": 8,
                       "gt": None, "deep": {"batch_size": 256}},
            "traffic": {"spp": 1}}
    s = spec()
    run = lambda **kw: harness.execute(  # noqa: E731
        ROOT, s, harness.find_cell(s, CELL), 2 ** 35 + 1, 0.1, False,
        "cpu", time.perf_counter(), overrides=size, **kw)
    r = run()
    assert r["correct"], r["checks"]
    checked = r["phases"]["checked"]
    assert checked[0][2] == 2304 and checked[-1][2] == 576
    bad = run(faults={"deep": "half_minibatches"})
    assert bad["checks"]["train_gap"]["value"] == 1.0


def test_the_counts_from_shapes():
    assert roofline_deep.forward_flops() == 434_400
    assert roofline_deep.forward_flops((3, 4, 2)) == 2 * (12 + 8)
    assert roofline_deep.mlp_flops(10, 2) == 434_400 * 16
    # one frame's ~3.1 M rows each way: ~5.4 TFLOP, a 0.08-s bound
    flops = roofline_deep.mlp_flops(3_100_000, 3_100_000)
    assert 5.3e12 < flops < 5.5e12
    assert roofline_deep.mfu_pct(3_100_000, 3_100_000, 1.0) == pytest.approx(
        100 * flops / 67e12)
    assert roofline_deep.RAY_BYTES == 96
    # PERF.md section 6's B4a bound: 518,400 camera rays, 0.0149 ms
    bound = roofline_deep.b4a_bound_s(518_400, 1, 38)
    assert bound == pytest.approx((518_400 * 96 + 38 * 112) / 3.35e12)
    assert 1e3 * bound == pytest.approx(0.0149, abs=5e-5)
    assert roofline.TRI_BYTES == 112


def test_the_capture_hook_leaves_the_frames_as_they_were():
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import (DeepLearningConfig,
                                        RadianceVolumeConfig, RenderConfig)
    from rlrpt_tpu_torch.deep import deep_wavefront as dw
    from rlrpt_tpu_torch.deep.neural_q import init_neural_q
    from rlrpt_tpu_torch.scene import cornell_box
    scene = cornell_box(device="cpu")
    cfg = RenderConfig(width=24, height=24, samples_per_pixel=1,
                       max_ray_bounces=6)
    rl, dl = RadianceVolumeConfig(), DeepLearningConfig(batch_size=64)

    def frames(cap):
        net, opt = init_neural_q(4, scene, dl, 12, "cpu")
        dw.CAPTURE = cap
        try:
            imgs = [dw.render_frame_neural_q_wavefront(
                s, scene, Camera.create([0.0, 0.0, -3.0]), net, opt, 0.05,
                cfg, rl, dl, pix_mux=4)[0] for s in (1, 2)]
        finally:
            dw.CAPTURE = None
        return imgs + [p.detach() for p in net.parameters()] + [opt.count]
    assert dw.CAPTURE is None
    plain = frames(None)
    armed = frames(dw.Capture(iterations=(2,), tail=True))
    assert all(torch.equal(a, b) for a, b in zip(plain, armed))


def _empty_run(**kw):
    base = dict(trace_summary=None, traced_answers=0, extra={},
                spans=tracing.Spans(), traffic={"loop": "neural_q_frames"},
                answer_s=[], answers=0, window_s=0.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("name", METRICS)
def test_the_new_metrics_read_none_with_nothing_to_read(name):
    reader = harness.load_module(ROOT / "benchmark" / "metrics"
                                 / f"{name}.py", f"m_{name}")
    assert reader.read(_empty_run()) is None
    # a traced window of another loop: nothing of the deep loop in it
    summary = {"window_s": 1.0, "busy_s": 0.5, "kernels": {},
               "device_ops": [], "idle_gaps": []}
    assert reader.read(_empty_run(trace_summary=summary,
                                  traced_answers=3)) is None


def test_a_traced_run_reads_the_deep_metrics():
    """On the CPU a trace has no device events: the recorder's metrics
    read, the device's read the empty device, B4a (no kernel) none."""
    from rlrpt_tpu_torch.utils import profiling
    profiling.RECORDER.reset()
    try:
        r = run_cell(trace=True)
    finally:
        profiling.RECORDER.reset()
    m = r["metrics"]
    assert r["correct"]
    assert {"mfu.deep", "device_idle.render", "kernels_per_iter.deep",
            "train_host_ms.deep", "host_syncs.deep"} <= set(m)
    assert 0 < m["mfu.deep"]["value"] < 100
    assert m["train_host_ms.deep"]["value"] > 0
    assert "b4a_roofline" not in m


@pytest.mark.chip
def test_the_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         str(2 ** 31 + 13), "--seconds", "2", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.splitlines()[-1])
    assert r["correct"], r["checks"]
    assert set(TRACED) <= set(r["metrics"])
