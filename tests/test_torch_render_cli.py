"""rlrpt_tpu_torch render CLI on the CPU (the kernels' plain twins)."""

import pytest

from rlrpt_tpu_torch.tools import render
from rlrpt_tpu_torch.utils.image import read_png
from _torch_parity import one_torch_thread  # noqa: F401

SMALL = ["--width", "16", "--height", "16", "--spp", "4", "--bounces", "8",
         "--device", "cpu"]


@pytest.mark.parametrize("mode", [["--mode", "default"], ["--mode", "mega"],
                                  ["--mode", "sarsa-mega", "--frames", "0"],
                                  ["--mode", "mega", "--russian-roulette"]],
                         ids=["default", "mega", "sarsa-mega", "mega-rr"])
def test_cli_writes_lit_png(tmp_path, mode):
    out = tmp_path / "r.png"
    assert render.main(mode + SMALL + ["--out", str(out)]) == 0
    img = read_png(str(out))
    assert img.shape == (16, 16, 3)
    assert img.max() > 0     # not black


def test_sarsa_mega_learning_frames_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="B2"):
        render.main(["--mode", "sarsa-mega", "--frames", "1", *SMALL,
                     "--out", str(tmp_path / "r.png")])
    assert "B2" in render.build_parser().format_help()
