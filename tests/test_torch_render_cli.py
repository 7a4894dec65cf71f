"""rlrpt_tpu_torch render CLI and scene bench on the CPU (the kernels'
plain twins)."""

import json

import pytest
import torch

from rlrpt_tpu.utils.stats import read_stats as jax_read_stats
from rlrpt_tpu_torch.radiance import map_io
from rlrpt_tpu_torch.scene import presets
from rlrpt_tpu_torch.tools import render
from rlrpt_tpu_torch.utils.image import read_png
from _torch_parity import one_torch_thread  # noqa: F401

SMALL = ["--width", "16", "--height", "16", "--spp", "4", "--bounces", "8",
         "--device", "cpu"]


@pytest.mark.parametrize("mode", [["--mode", "default"], ["--mode", "mega"],
                                  ["--mode", "sarsa-mega", "--frames", "0"],
                                  ["--mode", "mega", "--russian-roulette"],
                                  ["--mode", "wavefront"]],
                         ids=["default", "mega", "sarsa-mega", "mega-rr",
                              "wavefront"])
def test_cli_writes_lit_png(tmp_path, mode):
    out = tmp_path / "r.png"
    assert render.main(mode + SMALL + ["--out", str(out)]) == 0
    img = read_png(str(out))
    assert img.shape == (16, 16, 3)
    assert img.max() > 0     # not black


def test_sarsa_mega_learning_frames_not_ported(tmp_path, capsys):
    """Once a placeholder for the missing learning kernel: --frames 2 now
    learns two frames (printing td_scatters each) and renders with the
    learned map."""
    out = tmp_path / "r.png"
    assert render.main(["--mode", "sarsa-mega", "--frames", "2", *SMALL,
                        "--out", str(out)]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("frame ")]
    assert len(lines) == 2 and all("td_scatters" in ln for ln in lines)
    assert all(int(ln.split()[-1]) > 0 for ln in lines)
    img = read_png(str(out))
    assert img.shape == (16, 16, 3) and img.max() > 0
    assert "--frames 0" not in render.build_parser().format_help()


FINE = ["--width", "32", "--height", "32", "--spp", "4", "--bounces", "8",
        "--area-per-sample", "0.05", "--device", "cpu"]


@pytest.mark.parametrize("mode", [
    ["--mode", "sarsa", "--frames", "2"],
    ["--mode", "sarsa-fast", "--frames", "2"],
    ["--mode", "voronoi"],
    ["--mode", "importance", "--precompute-spp", "2",
     "--grid-resolution", "6"],
    ["--mode", "precomputed", "--precompute-spp", "2",
     "--grid-resolution", "6"]],
    ids=["sarsa", "sarsa-fast", "voronoi", "importance", "precomputed"])
def test_fine_map_modes_write_lit_png(tmp_path, mode, capsys):
    out = tmp_path / "r.png"
    assert render.main(mode + FINE + ["--out", str(out)]) == 0
    img = read_png(str(out))
    assert img.shape == (32, 32, 3) and img.max() > 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("frame ")]
    if "--frames" in mode:
        assert len(lines) == 2 and all("td_scatters" in ln for ln in lines)


def test_save_q_then_load_q_reproduces_the_table(tmp_path):
    """--save-q writes the learned Q; --load-q starts from it: the loaded
    table is the saved one to the text's 6 digits, and saving it again
    gives the same bytes.  The per-frame stats hold the visit invariant."""
    q_txt, q2_txt = tmp_path / "q.txt", tmp_path / "q2.txt"
    args = render.build_parser().parse_args(
        ["--mode", "sarsa-fast", "--frames", "2", "--save-q", str(q_txt),
         *FINE])
    _, aux = render.render(args)
    rows = aux["frames"]
    assert rows[0]["visits"] == rows[0]["td_scatters"] > 0
    assert rows[1]["visits"] - rows[0]["visits"] == rows[1]["td_scatters"]
    assert aux["table"].table.shape[1] == 16 and aux["table_seconds"] > 0
    learned = aux["vols"].q
    args = render.build_parser().parse_args(
        ["--mode", "importance", "--load-q", str(q_txt), *FINE])
    img, aux = render.render(args)
    torch.testing.assert_close(aux["vols"].q, learned, rtol=1e-5, atol=0)
    assert torch.isfinite(img).all()
    map_io.save_q_vals_to_file(aux["vols"], str(q2_txt))
    assert q2_txt.read_bytes() == q_txt.read_bytes()


@pytest.mark.parametrize("mode", ["sarsa", "sarsa-fast", "sarsa-mega"])
def test_stats_file(tmp_path, mode):
    """--stats appends one `avg_path loss zclp` line per learning frame,
    which the JAX package's reader reads (loss 0; zclp 0 for sarsa-mega,
    as its JAX CLI writes)."""
    path = tmp_path / "stats.txt"
    assert render.main(["--mode", mode, "--frames", "2", "--stats",
                        str(path), *FINE, "--out",
                        str(tmp_path / "r.png")]) == 0
    rows = jax_read_stats(str(path))
    assert len(rows) == 2 and all(r[1] == 0.0 and 1 <= r[0] <= 8
                                  for r in rows)
    assert all((r[2] == 0) == (mode == "sarsa-mega") for r in rows)


def test_scene_bench_prints_rows(capsys):
    """scene_bench on the CPU: one parseable JSON row per scene; the
    device figures (kernel time, share of bound) are null off the card."""
    from rlrpt_tpu_torch.tools import scene_bench
    assert scene_bench.main(["--device", "cpu", "--scenes",
                             "cornell,test_room", "--size", "16",
                             "--frames", "1"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [r["scene"] for r in rows] == ["cornell", "test_room"]
    assert [r["triangles"] for r in rows] == [38, 18]
    for r in rows:
        assert r["morton"] and r["device"] == "cpu"
        assert r["sec_per_frame"] > 0 and r["avg_path_length"] > 1
        assert r["ray_tri_tests_per_sec"] == pytest.approx(
            r["rays_per_sec"] * r["triangles"])
        assert r["kernel_ms"] is None


@pytest.mark.parametrize("mode", [["--mode", "mega"],
                                  ["--mode", "sarsa-mega", "--frames", "2"]],
                         ids=["mega", "sarsa-mega"])
def test_cli_renders_test_room(tmp_path, mode):
    out = tmp_path / "r.png"
    assert render.main(mode + ["--scene", "test_room", *SMALL, "--out",
                               str(out)]) == 0
    img = read_png(str(out))
    assert img.shape == (16, 16, 3) and img.max() > 0


@pytest.mark.parametrize("keep, sectors", [([], 121), (["--keep-grid"], 144)],
                         ids=["jax_mapping", "keep_grid"])
def test_sarsa_mega_keeps_the_grid_when_asked(keep, sectors):
    """--grid-resolution 12 learns on 11x11 sectors (the JAX tool's
    mapping) unless --keep-grid runs the reference's own 12x12; the
    sectors past the grid's are padding rows of the tables (to a multiple
    of 8), which no frame visits."""
    args = render.build_parser().parse_args(
        ["--mode", "sarsa-mega", "--frames", "1", "--scene", "test_room",
         "--grid-resolution", "12", *keep, *SMALL])
    img, aux = render.render(args)
    q, visits = aux["q"], aux["visits"]
    assert q.shape == (-(-sectors // 8) * 8, 24 * 16)
    assert float(visits[:sectors].sum()) == aux["frames"][0]["visits"] > 0
    assert float(visits[sectors:].sum()) == 0
    assert float(q[:sectors].min()) > 0 and img.shape == (16, 16, 3)


@pytest.mark.parametrize("name", list(presets.PRESETS))
def test_every_preset_renders_or_names_its_model(name, tmp_path,
                                                 monkeypatch):
    """Every --scene choice renders, or (an OBJ model that is not there)
    raises FileNotFoundError naming the file and RLRPT_MODELS_DIR."""
    monkeypatch.setattr(presets, "MODELS_DIR", str(tmp_path))
    argv = ["--mode", "mega", "--scene", name, "--width", "8", "--height",
            "8", "--spp", "1", "--bounces", "4", "--device", "cpu",
            "--out", str(tmp_path / "r.png")]
    if presets.get(name).obj is None:
        assert render.main(argv) == 0
        assert read_png(str(tmp_path / "r.png")).shape == (8, 8, 3)
    else:
        with pytest.raises(FileNotFoundError, match="RLRPT_MODELS_DIR"):
            render.main(argv)
