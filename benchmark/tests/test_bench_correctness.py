"""How ``correct`` is decided: the plain reference against the port's
twins, the control (the reference in bfloat16 in the program's place)
failing the limits, and faults planted in the timed path turning
``correct`` false.

The faults a cell can have: a step that returns its state unchanged; half
of the batch left out and the mean taken over the rest; an answer altered
where it is produced.  Every cell runs on one card, so none has an
exchange between chips to leave out.
"""

import subprocess
import sys

import pytest
import torch

from benchmark.reference import pathtrace as pt
from benchmark.reference import scenes as ref_scenes
from benchmark.tests.small import CELLS, ROOT, run_cell

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def test_reference_is_the_twins_on_the_cpu():
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import RenderConfig
    from rlrpt_tpu_torch.ops import guided_mega_train as gmt
    from rlrpt_tpu_torch.ops import megakernel as mk
    from rlrpt_tpu_torch.scene.cornell import cornell_box
    scene = cornell_box(device="cpu")
    tables = ref_scenes.cornell()
    tris, mat = tables.packed("cpu")
    p_tris, p_mat = mk.pack_scene(scene)
    assert torch.equal(tris, p_tris) and torch.equal(mat, p_mat)
    cfg = RenderConfig(width=20, height=12, samples_per_pixel=3,
                       max_ray_bounces=7)
    fr = pt.Frame(20, 12, 3, 7)
    cam = Camera.create((0.0, 0.0, -3.0))
    n_slots = mk.n_slots_for(cfg.n_pixels, 128, 1)
    img, _ = mk.render_default_mega(77, scene, cam, cfg, "cpu")
    rad, _, _ = pt.render(77, mk.camera_vector(cam), tris, mat, fr, n_slots,
                          1, torch.arange(cfg.n_pixels))
    assert torch.equal(img.reshape(-1, 3), rad[0] / 3)
    q, v = gmt.init_bin_q(40, 4, 11, 100 / 121, device="cpu")
    table = gmt.rebuild_bin_cdf(q, 11, 4, 40)
    assert torch.equal(table.cdf, pt.rebuild_cdf(q, 11))
    _, q1, v1, _ = gmt.render_sarsa_mega_train(5, scene, cam, table, q, v,
                                               cfg, 0.8 / 121, "cpu")
    _, _, _, rq1, rv1, _ = pt.learn_frame(
        5, mk.camera_vector(cam), tris, mat, fr, n_slots, 1, table.cdf,
        tables.luminance_tensor("cpu"), q, v, 11, 4, 0.8 / 121)
    assert torch.equal(v1, rv1)
    assert float((q1 - rq1).abs().max()) <= 1e-6 * float(rq1.abs().max())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct_and_the_control_is_not(cell):
    r = run_cell(cell, control=True)
    assert r["correct"], r["checks"]
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    failed = [k for k, v in r["control"].items() if v > limits[k]]
    assert failed, r["control"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_makes_the_run_incorrect(cell, fault):
    kind = "learn" if cell == "cornell_sarsa_mega_32spp" else "render"
    r = run_cell(cell, faults={kind: fault})
    assert not r["correct"], r["checks"]
    assert r["failed"] >= 1


@pytest.mark.parametrize("cell, answers, sound_calls", [
    ("cornell_mega_1spp", 8, 1 + 4),           # warm-up, frames 0-3
    ("cornell_sarsa_mega_32spp", 4, 3 + 6)])   # warm-up, jobs 0-1
def test_a_fault_late_in_the_window_makes_the_run_incorrect(
        monkeypatch, cell, answers, sound_calls):
    """The check takes the window's last answer and draws the rest from
    the whole window, so a fault that first shows late is seen.  The
    window is held to ``answers`` answers, whatever the machine's speed."""
    from benchmark.loops import common
    opens = common.Window.open

    def open_for(self):
        opens(self)
        return self.run.answers < answers
    monkeypatch.setattr(common.Window, "open", open_for)
    kind = "learn" if cell == "cornell_sarsa_mega_32spp" else "render"
    r = run_cell(cell, seconds=600.0,
                 faults={kind: f"late:{sound_calls}:answer_altered"})
    assert r["attempted"] == answers
    assert not r["correct"], r["checks"]


def test_the_sample_covers_the_window_and_keeps_the_last():
    import random
    from benchmark.loops.common import Sample
    rng = random.Random(5)
    counts = [0] * 50
    for _ in range(4000):
        s = Sample(rng, 2)
        for i in range(50):
            s.offer(i)
        kept = s.kept()
        assert kept[-1] == 49 or 49 in kept
        assert len(set(kept)) == len(kept)
        for i in s.drawn:
            counts[i] += 1
    # each of the 50 answers is drawn with probability 2/50: 160 of 4000
    assert min(counts) > 100 and max(counts) < 230, counts


@pytest.mark.chip
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "cornell_mega_1spp", "--seed", str(2 ** 31 + 11), "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert '"correct": true' in proc.stdout.splitlines()[-1]
