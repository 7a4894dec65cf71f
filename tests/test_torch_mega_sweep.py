"""rlrpt_tpu_torch.tools.mega_sweep's variant grid vs rlrpt_tpu's.

JAX's run_variant renders through rlrpt_tpu.ops.megakernel's
render_default_mega, which it imports when it is called, so the test
patches that name to run the kernel in interpret mode.  The port's
run_variant gets the kernel seeds that JAX draws from its folded keys,
so both render the same frames: the images are held as the megakernel
tests hold them, lane_util within 1e-6 relative.  Rays/s is a host
time, compared nowhere.
"""

import functools
import json

import jax
import pytest

from rlrpt_tpu import config as jconfig
from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.ops import megakernel as jmk
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu.tools import mega_sweep as jsweep
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RenderConfig
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.tools import mega_sweep as sweep
from _torch_parity import (assert_frame_parity, kernel_seed,  # noqa: F401
                           one_torch_thread)

CAM = (0.0, 0.0, -3.0)
TINY = dict(width=16, height=16, samples_per_pixel=1, max_ray_bounces=6)
TINY_ARGS = ["--device", "cpu", "--width", "16", "--height", "16",
             "--bounces", "6", "--repeats", "1"]


@pytest.mark.parametrize("r_tile,pix_mux", [(128, 2), (64, 1)],
                         ids=["one_tile", "four_tiles"])
def test_run_variant_matches_jax(monkeypatch, r_tile, pix_mux):
    """Spec r_tile,pix_mux,highest,1 at 16x16, 1 spp, 6 bounces,
    repeats 1.  At unroll 1 JAX's wavefront_iterations (its longest
    tile's loop count) is the port's (its longest slot's), so lane_util
    agrees to rounding; four_tiles has tiles of other lengths."""
    key = jax.random.PRNGKey(1984)
    monkeypatch.setattr(jmk, "render_default_mega", functools.partial(
        jmk.render_default_mega, interpret=True))
    rps_j, img_j, util_j = jsweep.run_variant(
        jax_cornell_box(), JCamera.create(CAM), jconfig.RenderConfig(**TINY),
        key, r_tile, pix_mux, "highest", 1, 1)
    rps_t, img_t, util_t = sweep.run_variant(
        cornell_box(device="cpu"), Camera.create(CAM), RenderConfig(**TINY),
        lambda i: kernel_seed(jax.random.fold_in(key, i)), r_tile, pix_mux,
        1, "cpu")
    assert rps_t > 0 and rps_j > 0
    assert tuple(img_t.shape) == img_j.shape == (16, 16, 3)
    # lane_util stands in for the avg path length (the same slots and
    # iterations on both sides); it is held tighter just below
    assert_frame_parity(img_t, {"avg_path_length": util_t}, img_j,
                        {"avg_path_length": util_j})
    assert 0.0 < util_t <= 1.0
    assert util_t == pytest.approx(util_j, rel=1e-6)


def test_default_variants_are_jax_grid_pairs():
    """The JAX grid's (r_tile, pix_mux) pairs, in its order."""
    pairs = dict.fromkeys(",".join(v.split(",")[:2])
                          for v in jsweep.DEFAULT_VARIANTS)
    assert list(sweep.DEFAULT_VARIANTS) == list(pairs)
    assert [sweep.parse_variant(v) for v in sweep.DEFAULT_VARIANTS] == [
        (1024, 32), (2048, 32), (512, 32), (1024, 64)]


def test_parse_variant():
    assert sweep.parse_variant("1024,32") == (1024, 32)
    assert sweep.parse_variant(" 512, 64 ,highest, 4") == (512, 64)
    for bad, match in (("1024,32,high3,2", "ROADMAP A11"),
                       ("1024,32,default,2", "ROADMAP A11"),
                       ("1024", "expected"), ("1024,32,highest", "expected"),
                       ("0,32", ">= 1")):
        with pytest.raises(ValueError, match=match):
            sweep.parse_variant(bad)


def test_cli_prints_a_row_per_variant(capsys):
    """--variants on the CPU: one JSON row per spec, JAX's keys; the
    error row for high3, and the sweep goes on after it; the first
    variant is mape_vs_f32's reference."""
    specs = "128,2;128,2,high3,2;64,1,highest,1"
    assert sweep.main(["--variants", specs] + TINY_ARGS) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["variant"] for r in rows] == specs.split(";")
    ok = [rows[0], rows[2]]
    for r in ok:
        assert set(r) == {"variant", "rays_per_sec", "lane_util",
                          "mape_vs_f32", "device"}
        assert r["rays_per_sec"] > 0 and 0.0 < r["lane_util"] <= 1.0
        assert r["device"] == "cpu"
    assert rows[0]["mape_vs_f32"] == 0.0
    assert set(rows[1]) == {"variant", "error"}
    assert "high3" in rows[1]["error"] and "A11" in rows[1]["error"]


def test_cli_defaults():
    args = sweep.build_parser().parse_args([])
    assert args.device == "cuda" and args.variants is None
    assert (args.repeats, args.width, args.height, args.bounces) == (
        8, 720, 720, 80)
    args = sweep.build_parser().parse_args(["--variants"])
    assert args.variants == ";".join(sweep.DEFAULT_VARIANTS)
    with pytest.raises(SystemExit, match="kernel points"):
        sweep.main(["--device", "cpu"])
