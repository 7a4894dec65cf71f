"""The deep-Q trainer's minibatch step as a CUDA graph
(deep/neural_q.py: ``train_on_batches``, ``_StepGraph``).

On the CPU: the op-by-op loop is chosen for a CPU tensor and under a mesh,
and a traced call records no replay or capture; the benchmark's reader
``train_graph_pct.deep`` reads the replay counts.  On the card (``-m
chip``): graphed training is bit for bit the
op-by-op loop's, a copied network captures graphs of its own and leaves
the original alone, and a profiled replay's GEMMs are in the device trace.
"""

import copy
import gc
import json
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from rlrpt_tpu_torch.config import DeepLearningConfig
from rlrpt_tpu_torch.deep import neural_q as nq
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.utils import profiling
from _torch_parity import card  # noqa: F401

B = 4096
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.RECORDER.reset()
    yield
    profiling.RECORDER.reset()


def _net(device, dl, seed=5):
    scene = cornell_box(device=device)
    net, opt = nq.init_neural_q(seed, scene, dl, 12, device=device)
    return scene, net, opt


def _batch(device, rows, seed, dead=()):
    """(loc, action, td, weight) of ``rows`` rays, most of them pending;
    the minibatches ``dead`` (of B rows) weighted 0 throughout."""
    g = torch.Generator().manual_seed(seed)
    loc = torch.rand((rows, 3), generator=g) * 2.0 - 1.0
    action = torch.randint(0, 144, (rows,), generator=g)
    td = torch.rand((rows,), generator=g) * 4.0
    w = (torch.rand((rows,), generator=g) < 0.8).float()
    for k in dead:
        w[k * B:(k + 1) * B] = 0.0
    return [x.to(device) for x in (loc, action, td, w)]


def _train(net, opt, scene, batch, dl):
    return nq.train_on_batches(net, opt, scene, *batch[:3], dl,
                               weights=batch[3])


def _state(net, opt):
    return [p.detach().clone() for p in net.parameters()] + [
        t.clone() for t in (*opt.mu, *opt.nu, opt.count)]


def test_the_op_by_op_loop_runs_on_the_cpu_and_under_a_mesh():
    cuda = torch.device("cuda", 0)
    assert nq._graphed(cuda, None)
    assert not nq._graphed(cuda, object())
    assert not nq._graphed(torch.device("cpu"), None)
    dl = DeepLearningConfig(batch_size=64, hidden_sizes=(16, 24, 16))
    scene, net, opt = _net("cpu", dl)
    with profile(activities=[ProfilerActivity.CPU]):
        for seed in (1, 2):
            _train(net, opt, scene, _batch("cpu", 150, seed), dl)
    rec = profiling.RECORDER
    assert rec.counts["train.minibatches"] == 6
    assert rec.calls["train_on_batches.grad"] == 6
    assert rec.calls["train_on_batches.adam"] == 6
    assert rec.counts["train.graph_replays"] == 0
    assert rec.counts["train.graph_captures"] == 0
    assert not rec.calls["train_on_batches.replay"]
    assert id(opt.count) not in nq._GRAPHS


@pytest.mark.parametrize("counts,value", [
    ({"train.minibatches": 40, "train.graph_replays": 35,
      "train.graph_captures": 5}, 87.5),
    ({"train.minibatches": 40, "train.graph_replays": 0,
      "train.graph_captures": 0}, 0.0),
    ({"train.minibatches": 40}, None),     # a program without graphs
    ({}, None)])
def test_train_graph_pct_reads_the_replay_counts(counts, value):
    read = harness.load_module(
        ROOT / "benchmark" / "metrics" / "train_graph_pct.deep.py",
        "metric_train_graph_pct_deep").read
    rec = profiling.RECORDER
    rec.calls["trace_frame_deep_wavefront.pack"] = 2
    rec.counts.update(counts)
    run = types.SimpleNamespace(
        traffic={"loop": "progressive"}, traced_answers=2,
        extra={"deep": {}}, trace_summary={"window_s": 4.0, "busy_s": 3.0})
    assert read(run) == value
    assert read(types.SimpleNamespace(**dict(vars(run), extra={}))) is None
    assert read(types.SimpleNamespace(
        **dict(vars(run), trace_summary=None))) is None


@pytest.mark.chip
def test_graphed_training_is_the_op_by_op_loop_bit_for_bit(card,
                                                           monkeypatch):
    """3 calls of 3 x 4096 + 2624 rows, the second minibatch weighted 0
    (its step skipped), then a call 1000 rows wide; after each the
    parameters, moments, step count and loss equal the op-by-op loop's."""
    dl = DeepLearningConfig()
    scene, net, opt = _net(card, dl)
    e_net, e_opt = copy.deepcopy(net), copy.deepcopy(opt)
    calls = [_batch(card, 3 * B + 2624, seed, dead=(1,))
             for seed in (1, 2, 3)] + [_batch(card, 1000, 4)]
    for batch in calls:
        with monkeypatch.context() as m:
            m.setattr(nq, "_graphed", lambda device, mesh: False)
            e_loss = _train(e_net, e_opt, scene, batch, dl)
        loss = _train(net, opt, scene, batch, dl)
        assert torch.equal(loss, e_loss)
        for got, want in zip(_state(net, opt), _state(e_net, e_opt)):
            assert torch.equal(got, want)
    # every live minibatch stepped once: none skipped, none run twice
    assert int(opt.count) == 3 * 3 + 1
    widths = sorted(k[1] for k in nq._GRAPHS[id(opt.count)])
    assert widths == [1000, 2624, B]
    assert id(e_opt.count) not in nq._GRAPHS


@pytest.mark.chip
def test_a_copied_network_captures_its_own_graphs(card):
    dl = DeepLearningConfig()
    scene, net, opt = _net(card, dl)
    _train(net, opt, scene, _batch(card, B + 100, 1), dl)
    c_net, c_opt = copy.deepcopy(net), copy.deepcopy(opt)
    before = _state(net, opt)
    for seed in (2, 3):
        _train(c_net, c_opt, scene, _batch(card, B + 100, seed), dl)
    for got, want in zip(_state(net, opt), before):
        assert torch.equal(got, want)
    assert int(c_opt.count) == int(opt.count) + 4
    mine, theirs = nq._GRAPHS[id(opt.count)], nq._GRAPHS[id(c_opt.count)]
    assert len(mine) == len(theirs) == 2
    assert not set(mine) & set(theirs)
    assert not {id(g) for g in mine.values()} & {id(g) for g in
                                                 theirs.values()}
    copied = _state(c_net, c_opt)
    _train(net, opt, scene, _batch(card, B + 100, 4), dl)
    for got, want in zip(_state(c_net, c_opt), copied):
        assert torch.equal(got, want)
    gone = id(c_opt.count)
    del c_net, c_opt, theirs
    gc.collect()
    assert gone not in nq._GRAPHS


@pytest.mark.chip
def test_a_profiled_replay_shows_its_gemms(card, tmp_path):
    dl = DeepLearningConfig()
    scene, net, opt = _net(card, dl)
    batch = _batch(card, 2 * B + 100, 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _train(net, opt, scene, batch, dl)
        torch.cuda.synchronize()
    rec = profiling.RECORDER
    assert rec.counts["train.minibatches"] == 3
    assert rec.counts["train.graph_captures"] == 2
    assert rec.counts["train.graph_replays"] == 3 - 2
    assert rec.calls["train_on_batches.capture"] == 2
    assert rec.calls["train_on_batches.grad"] == 2
    assert rec.calls["train_on_batches.replay"] == 1
    assert rec.syncs["graph_capture"] == 2
    profiling.RECORDER.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _train(net, opt, scene, batch, dl)
        torch.cuda.synchronize()
    assert rec.counts["train.graph_replays"] == 3
    assert not rec.counts["train.graph_captures"] and not rec.syncs
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    kernels = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    gemms = [k for k in kernels if "gemm" in k.lower()]
    print(f"an all-replay call of 3 minibatches: {len(kernels)} kernels, "
          f"{len(gemms)} GEMMs")
    # three layers' products forward and two backward a step, at least
    assert len(gemms) >= 3 * 3 * 3
