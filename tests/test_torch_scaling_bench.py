"""rlrpt_tpu_torch.tools.scaling_bench at sizes 1 and 2 (spawned gloo
groups on the CPU): tests/test_scaling_bench.py's row invariants, strong
and weak.  On the CPU the ranks share the host's cores, so no speedup is
asserted."""

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RenderConfig
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.tools.scaling_bench import run_scaling


def test_run_scaling_reports_all_sizes(capsys):
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=1,
                       max_ray_bounces=6, ray_tile=1024)
    res = run_scaling(cornell_box(device="cpu"),
                      Camera.create([0.0, 0.0, -3.0]), cfg, sizes=[1, 2, 4096],
                      repeats=1, device="cpu")
    assert "# skipping size 4096" in capsys.readouterr().out
    assert [r["devices"] for r in res] == [1, 2]
    for r in res:
        assert r["rays_per_sec"] > 0
        assert r["seconds"] > 0
        assert abs(r["rays_per_sec_per_device"] * r["devices"]
                   - r["rays_per_sec"]) < 1e-6 * r["rays_per_sec"] + 1e-9
    assert res[0]["speedup"] == 1.0 and res[0]["efficiency"] == 1.0


def test_run_scaling_weak_mode():
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=1,
                       max_ray_bounces=6, ray_tile=1024)
    res = run_scaling(cornell_box(device="cpu"),
                      Camera.create([0.0, 0.0, -3.0]), cfg, sizes=[1, 2],
                      repeats=1, mode="weak", device="cpu")
    assert [r["devices"] for r in res] == [1, 2]
    assert res[0]["pixels"] * 2 == res[1]["pixels"]
    assert res[0]["weak_efficiency"] == 1.0
    assert res[1]["weak_efficiency"] > 0
    assert all(r["mode"] == "weak" for r in res)
