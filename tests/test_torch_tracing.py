"""The program's own tracing (rlrpt_tpu_torch/utils/profiling.py) on the
plain twins at a tiny size: each launcher's spans in a profiler's Chrome
trace and in the recorder, nothing recorded and no clock read without a
profiler, host waits counted only on the card, and the benchmark's
readers of the recorder (benchmark/metrics/*.py).  On the card,
benchmark/tests/test_program_tracing.py holds the host-wait count against
torch's sync debug mode and the timed B2 against the plain one."""

import json
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import harness
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.ops import guided_mega as gm
from rlrpt_tpu_torch.ops import guided_mega_train as gt
from rlrpt_tpu_torch.ops import megakernel as mk
from rlrpt_tpu_torch.scene import cornell_box, generated
from rlrpt_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CFG = RenderConfig(width=8, height=8, samples_per_pixel=1, max_ray_bounces=3)
CAM = Camera.create([0.0, 0.0, -3.0])
G, UV, T_PAD = 11, 4, 40          # the Cornell box: 38 triangles
RL = RadianceVolumeConfig(grid_resolution=G)


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.RECORDER.reset()
    yield
    profiling.RECORDER.reset()


def _table():
    q, v = gt.init_bin_q(T_PAD, UV, G, RL.initial_radiance, device="cpu")
    return q, v, gt.rebuild_bin_cdf(q, G, UV, T_PAD)


def _default(tmp_path):
    mk.render_default_mega(3, cornell_box(device="cpu"), CAM, CFG, "cpu")


def _default_culled(tmp_path):
    scene = generated.torus_room(tmp_path / "torus.obj", 12, 12).load(
        device="cpu")
    assert mk.use_cull(scene.n_triangles)
    mk.render_default_mega(3, scene, CAM, CFG, "cpu")


def _learn(tmp_path):
    q, v, table = _table()
    gt.render_sarsa_mega_train(5, cornell_box(device="cpu"), CAM, table, q,
                               v, CFG, RL.radiance_threshold, "cpu")


def _guided(tmp_path):
    _, _, table = _table()
    gm.render_guided_mega(7, cornell_box(device="cpu"), CAM, table, CFG,
                          "cpu")


def _rebuild(tmp_path):
    q, _ = gt.init_bin_q(T_PAD, UV, G, RL.initial_radiance, device="cpu")
    gt.rebuild_bin_cdf(q, G, UV, T_PAD)


# launcher -> (the call, its spans on the CPU in order; on the card the
# frame wrappers add .outputs and .launch, and the host waits sync.*)
CASES = {
    "render_default_mega": (_default, ("pack", "assemble")),
    "render_default_mega.culled": (_default_culled,
                                   ("pack", "bvh", "assemble")),
    "render_sarsa_mega_train": (_learn,
                                ("pack", "tables", "check", "assemble")),
    "render_guided_mega": (_guided, ("pack", "tables", "check", "assemble")),
    "rebuild_bin_cdf": (_rebuild, ("cos", "sums", "cast")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_launcher_spans_in_the_trace_and_the_recorder(case, tmp_path):
    call, phases = CASES[case]
    launcher = case.split(".")[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(launcher):
            call(tmp_path)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    outer = [e for e in events if e["name"] == launcher]
    assert len(outer) == 1
    o0 = float(outer[0]["ts"])
    o1 = o0 + float(outer[0]["dur"])
    inner = sorted((e for e in events
                    if e["name"].startswith(launcher + ".")),
                   key=lambda e: float(e["ts"]))
    names = [f"{launcher}.{p}" for p in phases]
    assert [e["name"] for e in inner] == names
    end = o0
    for e in inner:   # inside the call, one after another
        s = float(e["ts"])
        assert end <= s and s + float(e["dur"]) <= o1, e["name"]
        end = s + float(e["dur"])
    rec = profiling.RECORDER
    # (the guided and learning cases build their table in the profile too)
    assert {n: c for n, c in rec.calls.items()
            if n.startswith(launcher + ".")} == dict.fromkeys(names, 1)
    for n in names:
        assert 0 < rec.self_ns[n] <= rec.ns[n]
    assert not rec.syncs and rec.b2_clock is None   # no card, no wait


@pytest.mark.parametrize("case", list(CASES))
def test_nothing_recorded_without_a_profiler(case, tmp_path, monkeypatch):
    def no_clock():
        raise AssertionError("a clock was read with no profiler")

    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter_ns=no_clock))
    assert profiling.span("a.b") is profiling.span("c.d")   # one no-op
    CASES[case][0](tmp_path)
    rec = profiling.RECORDER
    assert not rec.calls and not rec.ns and not rec.syncs
    assert not rec.lookups and not rec.hits
    assert rec.b2_clock is None


def test_host_sync_counts_only_card_tensors():
    card = types.SimpleNamespace(is_cuda=True)   # what host_sync reads
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer.phase"):
            with profiling.host_sync("site", torch.zeros(2)):
                pass
            with profiling.host_sync("site", card):
                sum(range(20000))
    rec = profiling.RECORDER
    assert dict(rec.syncs) == {"site": 1}
    # the span opens for both, so a CPU trace has the card's spans; only
    # the card's tensor is a wait
    assert rec.calls["sync.site"] == 2
    # the phase's self time leaves out the spans inside it
    assert rec.self_ns["outer.phase"] == (rec.ns["outer.phase"]
                                          - rec.ns["sync.site"])
    with profiling.host_sync("site", card):   # no profiler: nothing
        pass
    assert dict(rec.syncs) == {"site": 1}


def test_clock_buffer_is_kept_and_refuses_another_grid():
    rec = profiling.RECORDER
    assert rec.b2_clock is None and profiling.b2_shares(None) is None
    a = rec.clock(2, "cpu")
    assert a.shape == (2, len(profiling.CLOCK_COLS))
    assert profiling.b2_shares(a) is None   # no cycles yet
    a += 1
    assert rec.clock(2, "cpu") is a and rec.b2_clock is a
    with pytest.raises(ValueError, match="reset the recorder"):
        rec.clock(3, "cpu")
    rec.reset()
    assert rec.clock(3, "cpu").shape[0] == 3


def test_clock_takes_card_tables_only():
    q, v, table = _table()
    tris, mat = mk.pack_scene(cornell_box(device="cpu"))
    n_slots = mk.n_slots_for(CFG.n_pixels, 128, 1)
    clock = torch.zeros((1, len(profiling.CLOCK_COLS)), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tables only"):
        gt.mega_train_frame(
            5, mk.camera_vector(CAM), tris, mat, table.cdf.T.contiguous(),
            gt.bin_luminance(cornell_box(device="cpu"), T_PAD, UV)[0],
            gt.hs.sector_cos_thetas(G, "cpu").contiguous(), q, v, G, UV,
            RL.radiance_threshold, CFG, n_slots, 1, clock)


NEW_METRICS = ("host_syncs.learn", "prepare_ms.learn", "prepare_ms.render",
               "b2_step_pct", "b2_apply_pct", "b2_wait_pct",
               "prep_cache_hit_pct.learn", "prep_cache_hit_pct.render")


def _metric(name):
    return harness.load_module(ROOT / "benchmark" / "metrics"
                               / f"{name}.py", f"metric_{name}")


def _run(loop, traced_answers=4, traced=True):
    return types.SimpleNamespace(
        traffic={"loop": loop}, traced_answers=traced_answers,
        trace_summary={"window_s": 4.0, "busy_s": 3.0} if traced else None)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_metric_reads_none_with_nothing_recorded(name):
    read = _metric(name).read
    for loop in ("learning_jobs", "progressive"):
        assert read(_run(loop)) is None
    profiling.RECORDER.calls["render_default_mega.pack"] += 1
    assert read(_run("learning_jobs", traced=False)) is None
    assert read(_run("learning_jobs", traced_answers=0)) is None


def _fill_by_hand():
    rec = profiling.RECORDER
    ms = 1_000_000   # ns
    for name, calls, total, own in (
            ("render_sarsa_mega_train.pack", 20, 2 * ms, 2 * ms),
            ("render_sarsa_mega_train.tables", 20, 9 * ms, 3 * ms),
            ("render_sarsa_mega_train.check", 20, 7 * ms, 1 * ms),
            ("render_sarsa_mega_train.outputs", 20, 4 * ms, 4 * ms),
            ("render_sarsa_mega_train.launch", 20, 50 * ms, 50 * ms),
            ("render_default_mega.pack", 8, 2 * ms, 2 * ms),
            ("render_default_mega.outputs", 8, 1 * ms, 1 * ms),
            ("render_default_mega.launch", 8, 30 * ms, 30 * ms)):
        rec.calls[name], rec.ns[name], rec.self_ns[name] = calls, total, own
    rec.syncs.update({"up_vector": 42, "check_cdf": 22})
    rec.lookups.update({"pack": 22, "bin_lum": 20, "sector_cos": 40})
    rec.hits.update({"pack": 21, "bin_lum": 20, "sector_cos": 39})
    clock = rec.clock(4, "cpu")
    # start, step, wait1, apply, wait2, total, iterations; the b2 shares
    # read the blocks that apply (rows 1 and 3: apply at least half the
    # largest), whose length the frame follows
    clock[0] = torch.tensor([5, 50, 20, 10, 15, 100, 7])
    clock[1] = torch.tensor([5, 40, 20, 25, 10, 100, 7])
    clock[2] = torch.tensor([5, 60, 20, 0, 15, 100, 7])
    clock[3] = torch.tensor([5, 44, 20, 21, 10, 100, 7])


@pytest.mark.parametrize("name,value", [
    ("host_syncs.learn", (42 + 22) / 2),      # over 2 traced jobs
    ("prepare_ms.learn", (2 + 3 + 1 + 4) / 20),
    ("prepare_ms.render", (2 + 1) / 8),
    ("b2_step_pct", 100 * (40 + 44) / 200),
    ("b2_apply_pct", 100 * (25 + 21) / 200),
    ("b2_wait_pct", 100 * (30 + 30) / 200),
    ("prep_cache_hit_pct.learn", 100 * 80 / 82),
    ("prep_cache_hit_pct.render", 100 * 80 / 82)])
def test_new_metric_reads_a_recorder_filled_by_hand(name, value):
    _fill_by_hand()
    loop = "progressive" if name.endswith("render") else "learning_jobs"
    assert _metric(name).read(_run(loop, traced_answers=2)) == \
        pytest.approx(value)
