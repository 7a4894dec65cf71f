"""The readers of the frame loops' own spans (benchmark/metrics/
loop_host_ms.sarsa.py, loop_host_ms.deep.py, host_wait_ms.sarsa.py) on a
stub run and a recorder filled by hand: their values, and None without
the spans, the counts, the loop or a traced window."""

import types
from pathlib import Path

import pytest

from benchmark import harness
from rlrpt_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
MS = 1_000_000   # ns


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.RECORDER.reset()
    yield
    profiling.RECORDER.reset()


def _read(name):
    return harness.load_module(ROOT / "benchmark" / "metrics"
                               / f"{name}.py", f"metric_{name}").read


def _run(loop, traced=True, answers=2):
    return types.SimpleNamespace(
        traffic={"loop": "progressive"}, traced_answers=answers,
        extra={loop: {}},
        trace_summary={"window_s": 4.0, "busy_s": 0.4} if traced else None)


def _span(name, calls, total, own):
    rec = profiling.RECORDER
    rec.calls[name], rec.ns[name], rec.self_ns[name] = calls, total, own


def _fill():
    """Two fine-map frames of 400 steps and one deep frame of 120, their
    steps' spans and the fine-map frames' host waits."""
    rec = profiling.RECORDER
    _span("trace_frame_sarsa_wavefront.step", 400, 900 * MS, 200 * MS)
    _span("trace_frame_sarsa_wavefront.hit", 400, 300 * MS, 250 * MS)
    _span("trace_frame_deep_wavefront.step", 120, 2400 * MS, 60 * MS)
    rec.counts.update({"sarsa_wavefront.steps": 400,
                       "sarsa_wavefront.frames": 2,
                       "deep_wavefront.steps": 120,
                       "deep_wavefront.frames": 1})
    for site, calls, total in (("live_count", 202, 300 * MS),
                               ("flush", 16, 20 * MS),
                               ("camera", 2, 2 * MS),
                               ("class_ids", 2, 1 * MS),
                               ("bvh_info", 2, 1 * MS)):
        _span(f"sync.{site}", calls, total, total)
        rec.syncs[site] = calls
    # a host wait's span on a CPU tensor: no wait counted, not read
    _span("sync.other", 3, 50 * MS, 50 * MS)


@pytest.mark.parametrize("name,loop,value", [
    ("loop_host_ms.sarsa", "sarsa", 200 / 400),    # self ms over steps
    ("loop_host_ms.deep", "deep", 60 / 120),
    ("host_wait_ms.sarsa", "sarsa", (300 + 20 + 2 + 1 + 1) / 2)])
def test_a_reader_reads_the_recorded_spans(name, loop, value):
    _fill()
    assert _read(name)(_run(loop)) == pytest.approx(value, rel=1e-12)


READERS = {"loop_host_ms.sarsa": "sarsa", "loop_host_ms.deep": "deep",
           "host_wait_ms.sarsa": "sarsa"}


def _drop_span(name, loop):
    rec = profiling.RECORDER
    if name.startswith("host_wait_ms"):
        rec.syncs.clear()
    else:
        del rec.calls[f"trace_frame_{loop}_wavefront.step"]


def _drop_count(name, loop):
    what = "frames" if name.startswith("host_wait_ms") else "steps"
    del profiling.RECORDER.counts[f"{loop}_wavefront.{what}"]


@pytest.mark.parametrize("missing", ["span", "count", "loop", "window",
                                     "answers", "recording"])
@pytest.mark.parametrize("name", list(READERS))
def test_a_reader_reads_none_without_its_inputs(name, missing):
    loop = READERS[name]
    _fill()
    run = _run(loop)
    if missing == "span":
        _drop_span(name, loop)
    elif missing == "count":
        _drop_count(name, loop)
    elif missing == "loop":
        run = _run("deep" if loop == "sarsa" else "sarsa")
    elif missing == "window":
        run = _run(loop, traced=False)
    elif missing == "answers":
        run = _run(loop, answers=0)
    else:
        profiling.RECORDER.reset()
    assert _read(name)(run) is None
