"""The harness: cells, configurations, mixes and metrics found by name
(also a cell added as files only), the result line, the window's
statistics, the roofline counts, the frozen MAPE and the pinned ground
truth."""

import json
import math
import shutil
import statistics
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import harness, imagecmp, readers, roofline, stats, tracing
from benchmark.loops import learning_jobs
from benchmark.tests.small import CELLS, ROOT, run_cell, spec


def test_every_cell_finds_its_files():
    s = spec()
    assert [c["name"] for c in s["workloads"]] == list(CELLS)
    for cell in s["workloads"]:
        config, traffic = harness.cell_files(s, cell)
        assert config["name"] == cell["config"]
        assert (ROOT / "benchmark" / "loops"
                / f"{traffic['loop']}.py").is_file()
        assert (ROOT / "benchmark" / "scenes"
                / f"{config['scene']['kind']}.py").is_file()
        for trace in (False, True):
            for m in harness.metrics_for(s, cell["name"], trace):
                mod = harness.load_module(
                    ROOT / "benchmark" / "metrics" / f"{m['name']}.py", "m")
                assert callable(mod.read)


def test_per_layer_metrics_move_a_metric_their_cells_report():
    s = spec()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    for m in s["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)


def _copy_with_new_cell(tmp_path):
    """A checkout holding the benchmark plus a cell added as files only:
    a configuration, a mix and a per-layer metric."""
    root = tmp_path / "root"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    s = spec()
    config = json.loads((ROOT / "benchmark/configs/cornell_720.json")
                        .read_text())
    config.update(name="cornell_96", width=96, height=96)
    (root / "benchmark/configs/cornell_96.json").write_text(
        json.dumps(config))
    mix = json.loads((ROOT / "benchmark/traffic/progressive_1spp.json")
                     .read_text())
    mix.update(spp=2, warmup_frames=1)
    (root / "benchmark/traffic/progressive_2spp.json").write_text(
        json.dumps(mix))
    (root / "benchmark/metrics/frames_traced.py").write_text(
        "def read(run):\n    return run.traced_answers or None\n")
    s["configs"].append(dict(s["configs"][0], name="cornell_96",
                             file="benchmark/configs/cornell_96.json"))
    s["workloads"].append({"name": "cornell_96.p2", "config": "cornell_96",
                           "traffic": "progressive_2spp", "chips": 1,
                           "why": "a throwaway cell"})
    for m in s["end_to_end"]:
        if "workloads" in m and "cornell_mega_1spp" in m["workloads"]:
            m["workloads"].append("cornell_96.p2")
    s["per_layer"].append({"name": "frames_traced", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "paths_per_s",
                           "workloads": ["cornell_96.p2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    return root


def test_a_cell_added_as_files_runs(tmp_path):
    root = _copy_with_new_cell(tmp_path)
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(root)!r}, {str(ROOT)!r}]\n"
        "from pathlib import Path\n"
        "from benchmark import harness\n"
        "assert harness.__file__.startswith(sys.path[0])\n"
        f"root = Path({str(root)!r})\n"
        "s = harness.load_json(root / 'BENCHMARK.json')\n"
        "out = {}\n"
        "for trace in (False, True):\n"
        "    out[trace] = harness.execute(\n"
        "        root, s, harness.find_cell(s, 'cornell_96.p2'), 5, 0.3,\n"
        "        trace, 'cpu', time.perf_counter(),\n"
        "        overrides={'config': {'width': 12, 'height': 8, 'gt': None,\n"
        "                              'max_ray_bounces': 4}})\n"
        "print(json.dumps([out[False], out[True]]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    plain, traced = json.loads(proc.stdout.splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"paths_per_s", "frame_ms_p95",
                                     "setup_s"}
    assert plain["metrics"]["paths_per_s"]["unit"] == "paths/s"
    assert traced["metrics"]["frames_traced"]["value"] >= 1


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(trace):
    r = run_cell("cornell_mega_1spp", trace=trace, seconds=0.6)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert isinstance(r["correct"], bool) and r["correct"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in r["breakdown"].values())
        assert "launch_host_ms.render" in r["metrics"]
    else:
        assert set(r["metrics"]) == {"paths_per_s", "frame_ms_p95",
                                     "setup_s"}
    json.dumps(r)


def _fake_run(answer_s, loop="progressive", paths=518400):
    return types.SimpleNamespace(
        answer_s=list(answer_s), answers=len(answer_s),
        window_s=sum(answer_s), paths_per_answer=paths, setup_s=7.0,
        traffic={"loop": loop}, extra={}, spans=tracing.Spans(),
        trace_summary=None, traced_answers=0)


def _metric(name):
    return harness.load_module(ROOT / "benchmark" / "metrics"
                               / f"{name}.py", f"m_{name}")


def test_window_statistics_count_every_frame():
    frames = [0.0013] * 999 + [0.2]            # one stall of 200 ms
    run = _fake_run(frames)
    window = sum(frames)
    assert _metric("paths_per_s").read(run) == pytest.approx(
        1000 * 518400 / window)
    # the stall is 0.1% of the frames: the p95 does not see it, the rate
    # does (a mean of per-chunk medians would not)
    assert _metric("frame_ms_p95").read(run) == pytest.approx(1.3)
    assert _metric("paths_per_s").read(run) < 0.88 * 518400 / 0.0013
    stalls = [0.0013] * 90 + [0.05] * 10       # 10% stalled frames
    assert _metric("frame_ms_p95").read(_fake_run(stalls)) == \
        pytest.approx(50.0)
    jobs = _fake_run([0.25] * 39 + [1.25], loop="learning_jobs")
    assert _metric("job_s").read(jobs) == pytest.approx(11.0 / 40)
    assert _metric("paths_per_s").read(jobs) is None
    assert _metric("job_s").read(run) is None


def test_percentile_matches_statistics():
    rng = np.random.default_rng(3)
    for n in (2, 20, 101):
        v = list(rng.uniform(1, 2, n))
        assert stats.percentile(v, 95) == pytest.approx(
            statistics.quantiles(v, n=100, method="inclusive")[94])
        assert stats.percentile(v, 95) == pytest.approx(
            float(np.percentile(v, 95)))


def test_roofline_counts_from_shapes():
    seg, slots = 3.74e6, 518400
    ops = seg * (50 * 38 + 75)
    assert roofline.sweep_bound_s("B1", seg, 38, slots) == pytest.approx(
        ops / 67e12)
    # a frame of few segments is bound by its bytes: the scene read, the
    # outputs written
    assert roofline.sweep_bound_s("B1", 1.0, 38, slots) == pytest.approx(
        (38 * 112 + slots * 20) / 3.35e12)
    for s in (1.0, 1e3, 3.74e6, 1.2e8):     # the step's own work is ordered
        b1, b3, b2 = (roofline.sweep_bound_s(k, s, 38, slots)
                      for k in ("B1", "B3", "B2"))
        assert b1 <= b3 <= b2
    # B2's tables: the bf16 CDF read, Q and visits read and written
    assert roofline.binned_table_bytes(128, 640, True) == 128 * 640 * 18
    assert roofline.binned_table_bytes(128, 640, False) == 128 * 640 * 2


def test_roofline_share_reads_device_time():
    run = _fake_run([0.001] * 4)
    run.extra = {"n_tris": 38, "n_slots": 518400,
                 "kernel_segments": [3.74e6] * 4}
    run.traced_answers = 4
    run.trace_summary = {"kernels": {"mega_default_kernel":
                                     {"seconds": 4e-3, "count": 4}},
                         "busy_s": 4e-3, "window_s": 5e-3}
    bound = roofline.sweep_bound_s("B1", 3.74e6, 38, 518400)
    assert _metric("b1_roofline").read(run) == pytest.approx(
        100 * bound / 1e-3)
    assert _metric("device_idle.render").read(run) == pytest.approx(20.0)
    assert _metric("b2_roofline").read(run) is None   # never ran
    assert readers.traced_segments(run) == [3.74e6] * 4


def test_frozen_mape_is_the_ports():
    from rlrpt_tpu_torch.utils.image import mape_score
    rng = np.random.default_rng(11)
    for shape in ((4, 5, 3), (32, 32, 3)):
        gt = rng.uniform(0, 2, shape).astype(np.float32)
        p = (gt + rng.normal(0, 0.3, shape)).astype(np.float32)
        m = learning_jobs.Mape(gt, "cpu")
        m.add(torch.as_tensor(p))
        assert m.scores() == [mape_score(gt, p)]


def test_ground_truth_is_pinned(tmp_path):
    config = json.loads((ROOT / "benchmark/configs/cornell_720.json")
                        .read_text())
    gt = imagecmp.load_gt(ROOT, config["gt"])
    assert gt.shape == (720, 720, 3) and gt.dtype == np.float32
    bad = dict(config["gt"], sha256="0" * 64)
    with pytest.raises(ValueError, match="sha256"):
        imagecmp.load_gt(ROOT, bad)


def test_kernel_names_and_trace_reading(tmp_path):
    assert tracing.kernel_name(
        "(anonymous namespace)::mega_default_kernel(rlrpt::MegaParams)") \
        == "mega_default_kernel"
    assert tracing.kernel_name(
        "void (anonymous namespace)::mega_default_bvh_kernel<false>("
        "rlrpt::MegaParams, int)") == "mega_default_bvh_kernel<false>"
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "frame", "ts": 0,
         "dur": 50},
        {"ph": "X", "cat": "user_annotation", "name": "render", "ts": 0,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k(int)", "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k(int)", "ts": 20, "dur": 30},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 60,
         "dur": 10},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = tracing.read_trace(str(path))
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(50e-6)        # [10,50) + [60,70)
    assert s["kernels"]["k"] == {"seconds": pytest.approx(60e-6),
                                 "count": 2}
    gaps = dict(s["idle_gaps"])
    assert gaps["render"] == pytest.approx(10e-6)
    assert gaps["frame"] == pytest.approx(10e-6)
    assert gaps["outside any span"] == pytest.approx(30e-6)


def test_run_py_without_a_card_prints_no_result(tmp_path):
    cmd = [sys.executable, "benchmark/run.py", "--workload",
           "cornell_mega_1spp", "--seed", str(2 ** 31 + 5), "--seconds",
           "1", "--trace", "0"]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "benchmark", bare / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    proc = subprocess.run(cmd, cwd=bare, capture_output=True, text=True,
                          timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
