"""rlrpt_tpu_torch's tools vs rlrpt_tpu's: the bench twin's JSON line,
the sarsa_bench and neural_q_bench lines, nn_training_stats' per-spp
lines (tests/test_tools_smoke.py:28), training_curves' and sqd_plot's
files byte for byte against the JAX tools' on the same inputs, the
interactive viewer headless (tests/test_interactive.py) and its camera
moves against the JAX camera's; and the entry points' device defaults.

Tiny sizes on the plain twins: the lines' keys and counts, not their
times, which only the card gives.
"""

import ast
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.tools import sqd_plot as jsqd
from rlrpt_tpu.tools import training_curves as jcurves
from rlrpt_tpu.utils.stats import StatsLogger as JStatsLogger
from rlrpt_tpu_torch import bench
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.tools import (interactive, neural_q_bench,
                                   nn_training_stats, sarsa_bench, sqd_plot,
                                   training_curves)
from rlrpt_tpu_torch.utils.image import read_bmp, write_png
from rlrpt_tpu_torch.utils.stats import read_stats
from _torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _lines(capsys) -> list:
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def test_bench_twin_line(capsys):
    """One JSON line on stdout with bench.py's keys; a line per trial and
    the median's on stderr."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    jax_keys = next({k.value for k in node.keys} for node in ast.walk(tree)
                    if isinstance(node, ast.Dict) and any(
                        getattr(k, "value", None) == "vs_baseline"
                        for k in node.keys))
    assert bench.main(["--device", "cpu", "--size", "8"]) == 0
    out = capsys.readouterr()
    (line,) = out.out.splitlines()
    d = json.loads(line)
    assert set(d) == jax_keys == {"metric", "value", "unit", "vs_baseline"}
    assert d["unit"] == "rays/s" and d["value"] > 0
    assert d["vs_baseline"] == round(d["value"] / 1.0e8, 4)
    assert sum(x.startswith("trial ") for x in out.err.splitlines()) == 5
    assert bench.result_line(2.0e9)["metric"] == (
        "rays/sec/chip (cornell 720x720, 1 spp, 80-bounce cap)")


def test_sarsa_bench_lines(capsys):
    """The JAX tool's lines and keys (rlrpt_tpu/tools/sarsa_bench.py:
    110-224), table and grid search."""
    small = ["--device", "cpu", "--width", "16", "--height", "12",
             "--bounces", "5", "--frames", "1", "--area-per-sample", "0.05",
             "--min-drain-w", "16"]
    sarsa_bench.main(small)
    lines = _lines(capsys)
    assert [x.get("which") for x in lines] == [
        "default_wavefront", "default_mega", None, "sarsa_wavefront",
        "sarsa_mega_train", "sarsa_guided_infer"]
    timed = {"which", "sec_per_frame", "rays_per_sec"}
    assert set(lines[0]) == set(lines[1]) == timed
    assert set(lines[2]) == {"n_volumes", "search", "cells", "table_mb"}
    assert set(lines[3]) == timed | {
        "iters", "pix_mux", "cdf_dtype", "phase_widths", "phase_iters",
        "overhead_vs_default_wavefront"}
    assert set(lines[4]) == timed | {
        "iters", "uv_bins", "sector_grid", "state_space",
        "overhead_vs_default_mega", "speedup_vs_xla_sarsa_wavefront"}
    assert set(lines[5]) == timed | {"overhead_vs_default_mega"}
    assert lines[4]["state_space"] == "640 bins x 121 sectors"
    for x in lines:
        if "which" in x:
            assert x["sec_per_frame"] > 0 and x["rays_per_sec"] > 0
    sarsa_bench.main(small + ["--search", "grid", "--skip-mega",
                              "--skip-wavefront", "--cdf-dtype", "bf16"])
    lines = _lines(capsys)
    assert set(lines[0]) == {"n_volumes", "search", "grid_cells", "k_max"}
    assert lines[1]["cdf_dtype"] == "bf16"
    assert "overhead_vs_default_wavefront" not in lines[1]
    assert lines[2]["overhead_vs_default_mega"] is None


@pytest.mark.parametrize("impl,extra", [
    ("wavefront", ["--pix-mux", "2"]),
    ("wavefront", ["--pix-mux", "2", "--train-batching", "fused",
                   "--mlp-dtype", "bf16"]),
    ("lockstep", ["--spp", "2"])], ids=["wavefront", "fused_bf16",
                                        "lockstep"])
def test_neural_q_bench_lines(capsys, impl, extra):
    """The JAX tool's two lines (rlrpt_tpu/tools/neural_q_bench.py:
    131-163) for each schedule."""
    neural_q_bench.main(["--device", "cpu", "--size", "12", "--bounces", "4",
                         "--frames", "1", "--impl", impl] + extra)
    train, pre = _lines(capsys)
    assert train["which"] == f"neural_q_train_{impl}"
    assert pre["which"] == f"neural_q_pretrained_{impl}"
    rate = ("rays_per_sec" if impl == "wavefront"
            else "image_rays_per_sec_lower_bound")
    assert set(train) == {"which", "sec_per_frame", "spp", "size",
                          "pix_mux", "train_batching", "final_loss", rate}
    assert set(pre) == {"which", "sec_per_frame", "spp", "size", "pix_mux",
                        "mlp_dtype", "rays_per_sec"}
    assert np.isfinite(train["final_loss"]) and train[rate] > 0
    assert pre["rays_per_sec"] > 0


@pytest.mark.parametrize("impl", ["wavefront", "lockstep"])
def test_nn_training_stats_protocol_lines(tmp_path, capsys, impl):
    """tests/test_tools_smoke.py:28: frames x spp per-spp lines."""
    stats = tmp_path / "stats.txt"
    summary = tmp_path / "summary.json"
    nn_training_stats.main(["--frames", "2", "--spp", "2", "--size", "24",
                            "--bounces", "4", "--pix-mux", "2", "--impl",
                            impl, "--out", str(stats), "--json",
                            str(summary), "--device", "cpu"])
    rows = read_stats(str(stats))
    assert len(rows) == 4                      # frames * spp per-spp lines
    for plen, loss, zclp in rows:
        assert plen > 0 and loss >= 0 and zclp >= 0
    s = json.loads(summary.read_text())
    assert s["frames"] == 2 and s["spp"] == 2 and s["impl"] == impl
    assert tuple(s["first"]) == rows[0] and tuple(s["last"]) == rows[-1]
    assert s["files"] == [str(stats)]
    if impl == "wavefront":
        assert len(s["per_sample_extras"]) == 4


def test_training_curves_match_jax(tmp_path):
    """The same stats file gives the JAX tool's three PNGs, byte for
    byte."""
    rng = np.random.default_rng(2)
    rows = list(zip(rng.random(6) * 30, rng.random(6) * 1e9,
                    rng.integers(0, 1000, 6)))
    for d in ("j", "t"):
        (tmp_path / d).mkdir()
        log = JStatsLogger(str(tmp_path / d / "s.txt"))
        for row in rows:
            log.append(*row)
    files_j = jcurves.plot_stats(str(tmp_path / "j" / "s.txt"))
    files_t = training_curves.plot_stats(str(tmp_path / "t" / "s.txt"))
    assert [Path(f).name for f in files_t] == [Path(f).name for f in files_j]
    assert [Path(f).name for f in files_t] == [
        "s_path_length.png", "s_loss.png", "s_zclp.png"]
    for a, b in zip(files_j, files_t):
        assert Path(a).read_bytes() == Path(b).read_bytes()
    assert training_curves.main([]) == 1


def test_sqd_plot_matches_jax(tmp_path):
    """The same two images give the JAX tool's file name (the MAPE in it)
    and histogram, byte for byte."""
    rng = np.random.default_rng(5)
    gt = rng.random((20, 16, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(np.float32)
    names = {}
    for d in ("j", "t"):
        (tmp_path / d).mkdir()
        write_png(str(tmp_path / d / "gt.png"), gt)
        write_png(str(tmp_path / d / "pred.png"), pred)
    names["j"] = jsqd.compute_sqd_image(str(tmp_path / "j" / "gt.png"),
                                        str(tmp_path / "j" / "pred.png"))
    names["t"] = sqd_plot.compute_sqd_image(str(tmp_path / "t" / "gt.png"),
                                            str(tmp_path / "t" / "pred.png"))
    assert Path(names["t"]).name == Path(names["j"]).name
    assert "_mape_" in names["t"]
    assert Path(names["t"]).read_bytes() == Path(names["j"]).read_bytes()


@pytest.mark.parametrize("mode", ["default", "sarsa"])
def test_interactive_headless(tmp_path, mode):
    """tests/test_interactive.py on the port: two frames under SDL's dummy
    driver, the camera moving between them, the last saved."""
    out = str(tmp_path / f"shot_{mode}.bmp")
    env = dict(os.environ, SDL_VIDEODRIVER="dummy",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-m", "rlrpt_tpu_torch.tools.interactive",
         "--mode", mode, "--size", "48", "--spp", "1", "--bounces", "5",
         "--frames", "2", "--out", out, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "frame 1" in res.stdout
    img = read_bmp(out)
    assert img.shape == (48, 48, 3)
    assert img.max() > 0


def test_interactive_renderers_keep_learning():
    """_build_renderer without pygame: each mode renders two frames along
    the scripted camera path; the sarsa modes carry their map across."""
    from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
    from rlrpt_tpu_torch.scene import cornell_box
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1,
                       max_ray_bounces=5)
    rl = RadianceVolumeConfig(area_per_sample=0.05)
    for mode in ("default", "sarsa", "sarsa-mega"):
        render = interactive._build_renderer(mode, cornell_box(device="cpu"),
                                             cfg, rl, "cpu")
        cam = Camera.create([0.0, 0.0, -3.0])
        for frame in range(2):
            img, aux = render(frame, cam)
            assert img.shape == (16, 16, 3) and bool(img.isfinite().all())
            assert float(aux["avg_path_length"]) > 0
            cam = cam.rotate_left(0.05).move_forwards(0.02)
        if mode != "default":
            assert int(aux["td_scatter_count"]) > 0
    with pytest.raises(SystemExit):
        interactive._build_renderer("nope", cornell_box(device="cpu"), cfg,
                                    rl, "cpu")


def test_camera_moves_match_jax():
    """The port's camera controls (camera.cu:9-83) against the JAX
    camera's, one key sequence."""
    j, t = JCamera.create([0.0, 0.0, -3.0]), Camera.create([0.0, 0.0, -3.0])
    for op, a in [("rotate_left", 0.05), ("move_forwards", 0.02)] * 5 + [
            ("rotate_up", 0.1), ("rotate_right", 0.3),
            ("move_backwards", 0.1), ("rotate_down", 0.2)]:
        j, t = getattr(j, op)(a), getattr(t, op)(a)
        np.testing.assert_allclose(t.position, np.asarray(j.position),
                                   rtol=1e-6, atol=1e-7)
        assert t.yaw_y == float(j.yaw_y) and t.yaw_x == float(j.yaw_x)


def test_entry_points_default_to_the_card():
    """Every public constructor and loader defaults to the card: a caller
    gets the CPU only by asking for it."""
    from rlrpt_tpu_torch.deep.neural_q import init_neural_q
    from rlrpt_tpu_torch.integrators.differentiable import (pixel_gradients,
                                                            render_diff)
    from rlrpt_tpu_torch.nn.dq_network import DQNetwork
    from rlrpt_tpu_torch.nn.dynet_io import load_dynet_model
    from rlrpt_tpu_torch.ops.guided_mega_train import init_bin_q
    from rlrpt_tpu_torch.radiance.map_io import (load_volumes_from_selected,
                                                 load_volumes_npz)
    from rlrpt_tpu_torch.scene import presets
    from rlrpt_tpu_torch.scene.cornell import (cornell_box,
                                               monte_carlo_test_scene)
    from rlrpt_tpu_torch.scene.obj_importer import load_obj_scene
    from rlrpt_tpu_torch.scene.scene import build_scene
    from rlrpt_tpu_torch.tools import evaluate
    from rlrpt_tpu_torch.utils.checkpoint import load_training_state
    for fn in (cornell_box, monte_carlo_test_scene, build_scene,
               presets.ScenePreset.load, presets.load_scene, load_obj_scene,
               load_dynet_model, DQNetwork.from_layers, init_bin_q,
               load_training_state, load_volumes_npz,
               load_volumes_from_selected, init_neural_q, render_diff,
               pixel_gradients, bench.measure):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", (fn.__qualname__, default)
    for parser in (evaluate.build_parser(), sarsa_bench.build_parser(),
                   neural_q_bench.build_parser(),
                   nn_training_stats.build_parser(),
                   interactive.build_parser()):
        assert parser.parse_args([]).device == "cuda"
