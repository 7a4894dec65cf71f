"""The culled kernel B1 (rlrpt_tpu_torch/ops/megakernel.py,
``render_default_mega(cull=...)``): the port's form of the JAX
megakernel's AABB chunk cull is a walk of the frame's bounding-volume
hierarchy inside the slot loop.  Its twin (``run_slots_plain`` with the
plain walk as its closest hit) is held bit for bit against the sweep's
twin, and the culled render against the JAX package's culled render in
interpret mode, per pixel; the default cull decision against JAX's; the
tree builds a culled call makes; scene_bench's --cull rows.  On the card
(``-m chip``) the culled kernel gives the sweep kernel's frame bit for bit
at 720x720, and its twin's at 128x128, where the count-only build counts
the twin's visits and tests.
"""

import json

import jax
import numpy as np
import pytest
import torch

from rlrpt_tpu import config as jconfig
from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.ops import megakernel as jmk
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RenderConfig
from rlrpt_tpu_torch.ops import bvh as bv
from rlrpt_tpu_torch.ops import megakernel as mk
from rlrpt_tpu_torch.scene import cornell_box, generated, presets
from _torch_parity import (assert_frame_parity, assert_same_frame,  # noqa: F401
                           card, card_scenes, cornell_plus_clutter,
                           kernel_seed, one_torch_thread, torch_scene)

CAM = (0.0, 0.0, -3.0)
CLUTTER_CFG = dict(width=24, height=24, samples_per_pixel=4,
                   max_ray_bounces=8)
CORNELL_CFG = dict(width=32, height=32, samples_per_pixel=4,
                   max_ray_bounces=10)


def _card_frame(scene, size: int, spp: int, seed: int):
    """(the culled frame's arguments, its tree) at size x size, 80
    bounces, the launcher's r_tile and pix_mux, on the card."""
    cfg = RenderConfig(width=size, height=size, samples_per_pixel=spp,
                       max_ray_bounces=80)
    tris, mat = mk.pack_scene(scene)
    return (seed, mk.camera_vector(Camera.create(CAM)), tris, mat, cfg,
            mk.n_slots_for(cfg.n_pixels, mk.R_TILE, mk.PIX_MUX),
            mk.PIX_MUX), bv.build_bvh(tris)


@pytest.mark.chip
@pytest.mark.parametrize("spp", [1, 32])
@pytest.mark.parametrize("name,seed", [("clutter", 52), ("torus_room", 51)])
def test_culled_kernel_is_the_sweep_on_the_card(card_scenes, name, seed, spp):
    args, tree = _card_frame(card_scenes[name], 720, spp, seed)
    before = mk.KERNEL_CULL.launches
    culled = mk.mega_default_frame(*args, tree)
    assert mk.KERNEL_CULL.launches == before + 1
    assert_same_frame(culled, mk.mega_default_frame(*args))


@pytest.mark.chip
@pytest.mark.parametrize("name,seed", [("clutter", 52), ("torus_room", 51)])
def test_culled_kernel_is_its_twin_on_the_card(card_scenes, name, seed):
    """The twin walks the tree one torch op a step, so 128x128, 1 spp."""
    args, tree = _card_frame(card_scenes[name], 128, 1, seed)
    counts = {"visits": 0, "tests": 0}
    assert_same_frame(mk.mega_default_frame(*args, tree),
                      mk.mega_default_frame_plain(*args, tree, counts))
    assert mk.walk_counts(*args, tree) == (counts["visits"], counts["tests"])
    assert counts["tests"] > 0


def _frames(scene, seed, cfg, r_tile, pix_mux):
    """(sweep twin, culled twin) outputs of one frame on a torch scene."""
    tris, mat = mk.pack_scene(scene)
    cam = mk.camera_vector(Camera.create(CAM))
    n_slots = mk.n_slots_for(cfg.n_pixels, r_tile, pix_mux)
    sweep = mk.mega_default_frame(seed, cam, tris, mat, cfg, n_slots,
                                  pix_mux)
    culled = mk.mega_default_frame(seed, cam, tris, mat, cfg, n_slots,
                                   pix_mux, bv.build_bvh(tris))
    return sweep, culled


@pytest.fixture(scope="module")
def clutter():
    """cornell_plus_clutter (288 triangles, two chunks): the JAX launcher's
    culled render (its default there) and the port's two twins."""
    scene = cornell_plus_clutter()
    key = jax.random.PRNGKey(21)
    img_j, aux_j = jmk.render_default_mega(
        key, scene, JCamera.create(CAM), jconfig.RenderConfig(**CLUTTER_CFG),
        r_tile=128, pix_mux=4, interpret=True, precision="highest",
        cull=True)
    cfg = RenderConfig(**CLUTTER_CFG)
    sweep, culled = _frames(torch_scene(scene), kernel_seed(key), cfg, 128,
                            4)
    return cfg, sweep, culled, (img_j, aux_j)


@pytest.fixture(scope="module")
def cornell_16():
    """The Cornell box with the JAX T_CHUNK at 16 (38 triangles -> three
    chunks, as tests/test_megakernel.py:91-116 makes it): JAX's culled
    render and the port's two twins, the culled one over the box's tree,
    at test_torch_megakernel.py's Cornell point."""
    key = jax.random.PRNGKey(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmk, "T_CHUNK", 16)
        jax.clear_caches()
        img_j, aux_j = jmk.render_default_mega(
            key, jax_cornell_box().to_device(), JCamera.create(CAM),
            jconfig.RenderConfig(**CORNELL_CFG), r_tile=128, pix_mux=4,
            interpret=True, precision="highest", cull=True)
    jax.clear_caches()
    cfg = RenderConfig(**CORNELL_CFG)
    sweep, culled = _frames(cornell_box(device="cpu"), kernel_seed(key), cfg,
                            128, 4)
    return cfg, sweep, culled, (img_j, aux_j)


@pytest.mark.parametrize("case", ["clutter", "cornell_16"])
def test_culled_twin_bit_equal_to_sweep_twin(case, request):
    """The walk returns the sweep's hit, so rad, path_sum and iters are
    the sweep twin's bit for bit."""
    _, sweep, culled, _ = request.getfixturevalue(case)
    for name, a, b in zip(("rad", "path_sum", "iters"), sweep, culled):
        assert torch.equal(a, b), name
    assert float(sweep[1].sum()) > 0


@pytest.mark.parametrize("case", ["clutter", "cornell_16"])
def test_culled_render_matches_jax_culled(case, request):
    cfg, _, culled, (img_j, aux_j) = request.getfixturevalue(case)
    img_t, aux_t = mk.assemble(*culled, cfg)
    assert_frame_parity(img_t, aux_t, img_j, aux_j)


@pytest.mark.parametrize("n", [1, 38, 256, 257, 600])
def test_default_cull_is_jax(n):
    """JAX (megakernel.py:676-689): n_chunks = t_pad // min(t_pad,
    T_CHUNK); cull None -> n_chunks > 1; True on one chunk forced off."""
    t_pad = jmk._t_pad(n)
    multi = t_pad // min(t_pad, jmk.T_CHUNK) > 1
    assert mk.use_cull(n) == multi
    assert mk.use_cull(n, True) == multi
    assert not mk.use_cull(n, False)


def test_culled_call_builds_one_tree():
    """render_default_mega builds one tree per culled call and none for a
    one-chunk scene, even with cull=True; cull=False builds none."""
    cfg = RenderConfig(width=4, height=4, samples_per_pixel=1,
                       max_ray_bounces=2)
    cam = Camera.create(CAM)
    multi = torch_scene(cornell_plus_clutter())
    one = cornell_box(device="cpu")
    for scene, cull, built in ((multi, None, 1), (multi, True, 1),
                               (multi, False, 0), (one, None, 0),
                               (one, True, 0)):
        before = bv.BUILDS
        mk.render_default_mega(3, scene, cam, cfg, "cpu", cull=cull)
        assert bv.BUILDS - before == built, (scene.n_triangles, cull)
    assert mk.KERNEL.launches == mk.KERNEL_CULL.launches == 0


def test_wrapper_refuses_a_foreign_tree():
    tris, mat = mk.pack_scene(cornell_box(device="cpu"))
    tree = bv.build_bvh(tris.clone())
    cfg = RenderConfig(width=4, height=4, samples_per_pixel=1)
    with pytest.raises(ValueError, match="another triangle table"):
        mk.mega_default_frame(0, (0.0,) * 7, tris, mat, cfg, 128, 1, tree)


def test_walk_counts_on_the_cpu():
    """walk_counts on CPU tensors: the twin's visits and tests, at least
    one visit a segment, and fewer tests than the sweep's T a segment."""
    tris, mat = mk.pack_scene(torch_scene(cornell_plus_clutter()))
    tree = bv.build_bvh(tris)
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                       max_ray_bounces=4)
    cam = mk.camera_vector(Camera.create(CAM))
    n_slots = mk.n_slots_for(cfg.n_pixels, 128, 1)
    args = (5, cam, tris, mat, cfg, n_slots, 1, tree)
    visits, tests = mk.walk_counts(*args)
    segments = float(mk.mega_default_frame(*args)[1].sum())
    assert visits >= segments > 0
    assert 0 < tests < segments * tris.shape[0]


def test_scene_bench_cull_rows(capsys, tmp_path, monkeypatch):
    """--cull both: an off/on row pair on a multi-chunk scene (the torus
    room at 12 x 12 quads, 300 triangles), an off row alone on Cornell."""
    from rlrpt_tpu_torch.tools import scene_bench
    torus = generated.torus_room(tmp_path / "torus.obj", 12, 12)
    monkeypatch.setitem(presets.PRESETS, torus.name, torus)
    assert scene_bench.main(["--device", "cpu", "--scenes",
                             f"cornell,{torus.name}", "--size", "8",
                             "--frames", "1", "--bounces", "4",
                             "--cull", "both"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [(r["scene"], r["cull"]) for r in rows] == [
        ("cornell", False), (torus.name, False), (torus.name, True)]
    assert rows[1]["avg_path_length"] == rows[2]["avg_path_length"]
    assert all(r["kernel_ms"] is None for r in rows)
