"""The fine-map SARSA cell ``cornell_sarsa_fast_8spp`` on the CPU at a tiny
size: the harness finds its files by name; a sound run is correct and the
control (the reference in bfloat16) is not; each fault planted in the
timed path turns ``correct`` false; the drawn step lies in the widest
phase; the new metrics read None where a run has nothing to read, and a
traced run reads them; the reference loads no JAX and nothing of the
program.  The card's half runs the cell itself (``-m chip``)."""

import ast
import json
import subprocess
import sys
import time
import types

import pytest
import torch

from benchmark import harness, tracing
from benchmark.tests.small import ROOT, spec

CELL = "cornell_sarsa_fast_8spp"
# 2,438 volumes: the answer table's cells are a quarter of 3x the
# volumes' median spacing, 0.0357 a side (grid_bucket.build_volume_class_
# table), where the published set's are sqrt(0.003) / 4
TINY = {"config": {"width": 24, "height": 24, "max_ray_bounces": 6,
                   "volumes": {"area_per_sample": 0.01, "n_volumes": None},
                   "answer_table": {"cell": 0.03570471704006195}},
        "traffic": {"spp": 2}}
METRICS = ("kernels_per_iter.sarsa", "step_host_ms.sarsa",
           "host_syncs.sarsa", "b4a_roofline.sarsa")
TRACED = ("device_idle.render",) + METRICS   # the cell's traced metrics
GAPS = ("init_gap", "carry_gap", "hit_gap", "vol_gap", "q_gap", "visits_gap",
        "irr_gap", "sector_gap", "rad_gap", "cdf_gap", "img_gap")


def run_cell(seconds=0.3, trace=False, overrides=TINY, seed=2 ** 33 + 9,
             **kw):
    s = spec()
    return harness.execute(ROOT, s, harness.find_cell(s, CELL), seed,
                           seconds, trace, "cpu", time.perf_counter(),
                           overrides=overrides, **kw)


def test_the_harness_finds_the_cell():
    s = spec()
    cell = harness.find_cell(s, CELL)
    assert cell["chips"] == 1 and cell["config"] == "cornell_720_volumes"
    config, traffic = harness.cell_files(s, cell)
    assert config["name"] == "cornell_720_volumes" and config["reduced"] == []
    assert traffic["loop"] == "sarsa_fast_frames"
    assert (ROOT / "benchmark/loops/sarsa_fast_frames.py").is_file()
    assert (ROOT / f"benchmark/scenes/{config['scene']['kind']}.py").is_file()
    v = config["volumes"]
    assert (v["sector_grid"], v["area_per_sample"], v["n_volumes"]) == (
        12, 0.001, 24_526)
    assert (config["width"], config["height"], config["max_ray_bounces"],
            traffic["spp"]) == (720, 720, 80, 8)
    assert set(traffic["limits"]) == set(GAPS)
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
    assert set(limits) == set(GAPS)
    failed = [k for k, v in r["control"].items() if v > limits[k]]
    assert {"init_gap", "carry_gap", "hit_gap", "q_gap", "sector_gap",
            "rad_gap"} <= set(failed), r["control"]
    json.dumps(r)


@pytest.mark.parametrize("fault, gaps", [
    ("half_td", ("q_gap", "visits_gap")),
    ("next_vol_shifted", ("vol_gap",)),
    ("cdf_not_rebuilt", ("cdf_gap",)),
    ("image_scaled", ("img_gap",)),
    ("not_carried", ("carry_gap",))])
def test_a_planted_fault_makes_the_run_incorrect(fault, gaps):
    # a frame not carried shows in the next frame: a window of two or
    # more (a frame takes ~1.1 s on the CPU)
    r = run_cell(faults={"sarsa": fault},
                 seconds=3.0 if fault == "not_carried" else 0.3)
    assert not r["correct"], r["checks"]
    assert r["attempted"] >= (2 if fault == "not_carried" else 1)
    for gap in gaps:
        assert r["checks"][gap]["value"] > r["checks"][gap]["limit"], gap


def test_the_drawn_step_lies_in_the_widest_phase():
    """At 96x96 the frame drains 2,304 slots to 576: the drawn step is one
    of the 2,304-wide phase's, the last frame's last live step the 576-wide
    phase's."""
    size = {"config": dict(TINY["config"], width=96, height=96),
            "traffic": {"spp": 1}}
    r = run_cell(seconds=0.1, overrides=size, seed=2 ** 35 + 1)
    assert r["correct"], r["checks"]
    checked = r["phases"]["checked"]
    assert checked[0][2] == 2304 and checked[-1][2] == 576


def _empty_run(**kw):
    base = dict(trace_summary=None, traced_answers=0, extra={},
                spans=tracing.Spans(), traffic={"loop": "sarsa_fast_frames"},
                answer_s=[], answers=0, window_s=0.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("name", METRICS)
def test_the_new_metrics_read_none_with_nothing_to_read(name):
    reader = harness.load_module(ROOT / "benchmark" / "metrics"
                                 / f"{name}.py", f"m_{name}")
    assert reader.read(_empty_run()) is None
    # a traced window of another loop: nothing of the SARSA loop in it
    summary = {"window_s": 1.0, "busy_s": 0.5, "kernels": {},
               "device_ops": [], "idle_gaps": []}
    assert reader.read(_empty_run(trace_summary=summary,
                                  traced_answers=3)) is None


def test_a_traced_run_reads_the_sarsa_metrics():
    """On the CPU a trace has no device events and the host waits count
    only on the card: the recorder's metrics read, B4a (no kernel)
    none."""
    from rlrpt_tpu_torch.utils import profiling
    profiling.RECORDER.reset()
    try:
        r = run_cell(trace=True)
    finally:
        profiling.RECORDER.reset()
    m = r["metrics"]
    assert r["correct"]
    assert {"device_idle.render", "kernels_per_iter.sarsa",
            "step_host_ms.sarsa", "host_syncs.sarsa"} <= set(m)
    assert m["step_host_ms.sarsa"]["value"] > 0
    assert m["host_syncs.sarsa"]["value"] == 0
    assert "b4a_roofline.sarsa" not in m


def test_the_reference_loads_no_jax_and_nothing_of_the_program():
    path = ROOT / "benchmark/reference/sarsa_volumes.py"
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0] in
                harness.FORBIDDEN + ("rlrpt_tpu_torch",)]
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import benchmark.reference.sarsa_volumes\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(ast.literal_eval(proc.stdout.splitlines()[-1]))
    assert not loaded & set(harness.FORBIDDEN + ("rlrpt_tpu_torch",))


@pytest.mark.chip
def test_the_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         str(2 ** 31 + 17), "--seconds", "2", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.splitlines()[-1])
    assert r["correct"], r["checks"]
    assert set(TRACED) <= set(r["metrics"])
