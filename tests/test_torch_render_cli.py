"""rlrpt_tpu_torch render CLI on the CPU (the kernels' plain twins)."""

import pytest

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
