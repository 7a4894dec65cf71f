"""The deep-Q path's own tracing (utils/profiling.py; deep/deep_wavefront.py,
deep/neural_q.py) at a tiny size on the CPU: nothing recorded without a
profiler; with one, every stage's span and counters that equal the
frames' own aux and Adam state; frames, weights and stats bit for bit the
same with tracing on or off and with the capture hook armed or not.  On
the card (``-m chip``), every host wait of a training frame is one the
program counts, site for site, against torch's sync debug mode and the
callers of ``torch.cuda.synchronize`` (which that mode does not see: the
minibatch graphs' captures wait there)."""

import collections
import sys
import types
import warnings
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import (DeepLearningConfig, RadianceVolumeConfig,
                                    RenderConfig)
from rlrpt_tpu_torch.deep import deep_wavefront as dw
from rlrpt_tpu_torch.deep import neural_q as nq
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.utils import profiling
from _torch_parity import card, ops_outside  # noqa: F401

CFG = RenderConfig(width=16, height=16, samples_per_pixel=1,
                   max_ray_bounces=5)
DL = DeepLearningConfig(batch_size=32, hidden_sizes=(16, 24, 16))
RL = RadianceVolumeConfig(grid_resolution=6)
CAM = Camera.create([0.0, 0.0, -3.0])
STAGES = ("pack", "hit", "forward", "td", "train", "sample", "transport",
          "flush")
# the spans an op of a frame may lie in: the loop's, its host waits', the
# closest-hit launcher's and the training's
SPANS = ("trace_frame_deep_wavefront.", "render_frame_neural_q_wavefront.",
         "sync.", "closest_hit_mat_mxu.", "train_on_batches.")


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.RECORDER.reset()
    yield
    profiling.RECORDER.reset()
    dw.CAPTURE = None


def _net(device="cpu", dl=DL, rl=RL, seed=3):
    scene = cornell_box(device=device)
    net, opt = nq.init_neural_q(seed, scene, dl, rl.grid_resolution,
                                device=device)
    return scene, net, opt


def _frames(n=2, device="cpu", cfg=CFG, dl=DL, rl=RL, made=None):
    """``n`` training frames from a fresh net (or the ``made`` one);
    returns (images, the net's and Adam's state after them, the frames'
    aux, the Adam steps before the frames)."""
    scene, net, opt = made or _net(device, dl, rl)
    count0 = opt.count.clone()          # read after: no wait here
    imgs, auxes = [], []
    for f in range(n):
        img, _, _, _, aux = dw.render_frame_neural_q_wavefront(
            10 + f, scene, CAM, net, opt, 0.05, cfg, rl, dl, pix_mux=4)
        imgs.append(img)
        auxes.append(aux)
    state = [p.detach().clone() for p in net.parameters()]
    state += [*opt.mu, *opt.nu, opt.count]
    return imgs, state, auxes, count0


def test_nothing_is_recorded_without_a_profiler(monkeypatch):
    def no_clock():
        raise AssertionError("a span opened with no profiler")

    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter_ns=no_clock))
    _frames(1)
    rec = profiling.RECORDER
    assert not rec.calls and not rec.ns and not rec.syncs
    assert not rec.counts and not rec.tallies
    assert "trace_frame_deep_wavefront.step" not in rec.calls


def test_every_op_of_a_frame_lies_in_a_span():
    scene, net, opt = _net()
    dw.CAPTURE = dw.Capture(iterations=(1,), tail=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dw.render_frame_neural_q_wavefront(10, scene, CAM, net, opt, 0.05,
                                           CFG, RL, DL, pix_mux=4)
    assert ops_outside(prof, SPANS) == {}
    rec = profiling.RECORDER
    steps = rec.counts["deep_wavefront.steps"]
    assert rec.calls["trace_frame_deep_wavefront.step"] == steps > 0
    for name in ("slots", "totals"):
        assert rec.calls[f"trace_frame_deep_wavefront.{name}"] == 1
    assert rec.calls["render_frame_neural_q_wavefront.assemble"] == 1
    assert rec.calls["closest_hit_mat_mxu.launch"] == steps
    # two copies of each armed step: step 1 and the final phase's
    assert rec.calls["trace_frame_deep_wavefront.capture"] >= 2 * 2


def test_counters_equal_the_frames_own_aux():
    with profile(activities=[ProfilerActivity.CPU]):
        _, state, auxes, count0 = _frames(2)
    rec = profiling.RECORDER
    n = rec.tally_values()
    steps = rec.counts["deep_wavefront.steps"]
    assert rec.counts["deep_wavefront.frames"] == 2
    assert n["deep_wavefront.iterations"] == sum(
        int(a["wavefront_iterations"]) for a in auxes)
    assert steps >= n["deep_wavefront.iterations"] > 0
    for stage in STAGES:
        assert rec.calls[f"trace_frame_deep_wavefront.{stage}"] >= 2, stage
    for stage in ("hit", "forward", "td", "train", "sample", "transport"):
        assert rec.calls[f"trace_frame_deep_wavefront.{stage}"] == steps
    assert rec.calls["trace_frame_deep_wavefront.pack"] == 2
    # 16x16 at 4 pixels a slot: one 64-slot phase, 2 minibatches a step
    minibatches = rec.counts["train.minibatches"]
    assert minibatches == 2 * steps
    assert rec.calls["train_on_batches.adam"] == minibatches
    assert rec.calls["train_on_batches.grad"] == minibatches
    # on the CPU every step runs op by op: no CUDA graph
    assert rec.counts["train.graph_replays"] == 0
    assert rec.counts["train.graph_captures"] == 0
    taken = int(state[-1]) - int(count0)    # the Adam steps taken
    assert 0 < taken < minibatches          # the first steps have none
    assert n["deep_wavefront.rays"] >= n["deep_wavefront.rows_forwarded"] > 0
    assert 0 < n["train.rows"] <= n["deep_wavefront.rays"]
    assert not rec.syncs                    # host waits count on the card


def test_frames_are_the_same_traced_and_captured():
    plain = _frames(2)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _frames(2)
    dw.CAPTURE = dw.Capture(iterations=(1, 4), tail=True)
    captured = _frames(2)
    cap, dw.CAPTURE = dw.CAPTURE, None
    assert set(cap.records) == {1, 4} and cap.tail_records and cap.flushes
    for other in (traced, captured):
        for a, b in zip(plain[0] + plain[1], other[0] + other[1]):
            assert torch.equal(a, b)
        for x, y in zip(plain[2], other[2]):
            for k, v in x.items():
                if isinstance(v, torch.Tensor):
                    assert torch.equal(v, y[k]), k


def test_capture_keeps_the_last_live_steps_of_the_final_phase():
    cap = dw.Capture(tail=True)
    dw.CAPTURE = cap
    _frames(1)
    dw.CAPTURE = None
    assert 1 <= len(cap.tail_records) <= dw.SYNC_EVERY
    assert [r["step"] for r in cap.tail_records] == list(
        range(cap.steps - len(cap.tail_records), cap.steps))
    assert any(bool(r["live"]) for r in cap.tail_records)
    rec = cap.tail_records[-1]
    assert rec["before"][0].shape == rec["trained"][-1][0].shape
    assert rec["qs"].shape == (rec["width"], RL.grid_resolution ** 2)


# the file of each counted host wait (the frame torch names in its
# warning, or the caller of torch.cuda.synchronize, which torch's sync
# debug mode does not see: torch.cuda.graph's, in torch/cuda/graphs.py)
SITES = {"mesh.py": "live_count", "sarsa_wavefront.py": "flush",
         "deep_wavefront.py": "camera", "bvh.py": "bvh_info",
         "graphs.py": "graph_capture"}


@pytest.mark.chip
def test_every_host_wait_of_a_frame_is_counted(card, monkeypatch):
    cfg = RenderConfig(width=128, height=128, samples_per_pixel=1,
                       max_ray_bounces=80)
    dl = DeepLearningConfig()
    rl = RadianceVolumeConfig(grid_resolution=12)
    _frames(1, "cuda", cfg, dl, rl)     # every first call, unrecorded
    made = _net("cuda", dl, rl)          # the net's copy to the card
    torch.cuda.synchronize()
    profiling.RECORDER.reset()
    synchronize, callers = torch.cuda.synchronize, []

    def spy(device=None):
        callers.append(sys._getframe(1).f_code.co_filename)
        return synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.set_sync_debug_mode("warn")
        monkeypatch.setattr(torch.cuda, "synchronize", spy)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                _frames(2, "cuda", cfg, dl, rl, made)
        finally:
            monkeypatch.undo()
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    seen = collections.Counter(
        SITES.get(Path(w.filename).name, f"{w.filename}:{w.lineno}")
        for w in caught if "synchroniz" in str(w.message))
    seen.update(SITES.get(Path(f).name, f) for f in callers)
    counted = collections.Counter(profiling.RECORDER.syncs)
    print(f"host waits of 2 frames: torch's sync debug mode and "
          f"torch.cuda.synchronize {dict(seen)}, counted {dict(counted)}")
    assert seen == counted
    assert counted["bvh_info"] == counted["camera"] == 2
    # the fresh net captures each minibatch width once, in its first frame
    assert counted["graph_capture"] == (
        profiling.RECORDER.counts["train.graph_captures"]) > 0
