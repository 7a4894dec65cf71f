"""Shared helpers of the tests that hold rlrpt_tpu_torch against rlrpt_tpu.

Inputs are made with numpy from fixed seeds and handed to both packages;
the JAX megakernels run in interpret mode at precision="highest".

The card cases (marked ``chip``, taking the ``card`` fixture) hold each
CUDA kernel against its torch twin on the card and skip without one; they
build their inputs with the port alone.  Run them on the card with
``python -m pytest -m chip tests/test_torch_*.py``; tests/conftest.py
keeps JAX on the CPU there too.
"""

import collections
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlrpt_tpu.scene import build_scene as jax_build_scene
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu.scene import obj_importer as jobj
from rlrpt_tpu.scene import presets as jpresets
from benchmark.tracing import kernel_name
from rlrpt_tpu_torch.ops.guided_mega_train import init_bin_q
from rlrpt_tpu_torch.scene import build_scene, cornell_box, generated, presets
from rlrpt_tpu_torch.scene.scene import morton_sort_surfaces
from rlrpt_tpu_torch.utils.convert import scene_from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The twins step over a few hundred slots; torch's thread pool only
    adds contention under the test runner's worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def card():
    """The CUDA card; a case that takes it skips where torch sees none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def card_scenes(card, tmp_path_factory):
    """name -> a scene of the card cases, on the card: the Cornell box,
    clutter_scene, the test room and the generated torus room at
    bunny.obj's size (4,980 triangles), also Morton-sorted."""
    torus = generated.torus_room(
        tmp_path_factory.mktemp("torus") / "torus_room.obj",
        *generated.BUNNY_SIZE)
    room = torus.load(device=card)
    return {"cornell": cornell_box(device=card),
            "clutter": clutter_scene(card),
            "test_room": presets.load_scene("test_room", device=card),
            "torus_room": room,
            "torus_room_morton": morton_sort_surfaces(room)}


def assert_same_frame(a, b) -> None:
    """Two megakernel frames' rad, path_sum and iters, bit for bit."""
    for name, x, y in zip(("rad", "path_sum", "iters"), a, b):
        assert torch.equal(x, y), name
    assert float(a[1].double().sum()) > 0


def ops_outside(prof, prefixes) -> dict:
    """The top-level ``aten::`` ops of a torch.profiler profile (no aten op
    above them) whose innermost enclosing span starts with none of
    ``prefixes``, counted by that span's name (None: in no span)."""
    outside = collections.Counter()
    for e in prof.events():
        if not e.name.startswith("aten::"):
            continue
        holder, p = None, e.cpu_parent
        while p is not None and not p.name.startswith("aten::"):
            if holder is None and p.is_user_annotation:
                holder = p.name
            p = p.cpu_parent
        if p is None and not (holder or "").startswith(tuple(prefixes)):
            outside[holder] += 1
    return dict(outside)


#: The fine-map SARSA step's kernels, T2-T6, each run once a step
STEP_KERNELS = ("rlrpt_sarsa::sarsa_transport_kernel",
                "rlrpt_td::lookup_kernel", "rlrpt_td::targets_kernel",
                "rlrpt_td::scatter_kernel", "rlrpt_td::apply_kernel")


def device_kernels(prof, path) -> collections.Counter:
    """The device kernels a profile ran, counted by name without template
    arguments (``benchmark.tracing.kernel_name``), from its Chrome
    trace."""
    prof.export_chrome_trace(str(path))
    events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    return collections.Counter(
        kernel_name(e["name"]).split("<")[0] for e in events
        if e.get("ph") == "X" and e.get("cat") == "kernel")


def kernel_seed(key) -> int:
    """The int seed the JAX megakernel launchers draw from their key."""
    return int(jax.random.randint(key, (1,), 0, jnp.iinfo(jnp.int32).max,
                                  dtype=jnp.int32)[0])


def torch_scene(jax_scene, device="cpu"):
    return scene_from_numpy(jax_scene.v0, jax_scene.v1, jax_scene.v2,
                            jax_scene.normal, jax_scene.diffuse_c,
                            jax_scene.emission, jax_scene.luminance,
                            jax_scene.n_surfaces, device=device)


def jax_preset(p):
    """The JAX package's preset with the port preset's values."""
    return jpresets.ScenePreset(
        name=p.name, obj=p.obj, camera_position=p.camera_position,
        default_rgb=p.default_rgb,
        material_rules=tuple(jobj.MaterialRule(r.lo, r.hi, r.rgb)
                             for r in p.material_rules),
        light_specs=tuple(jobj.LightSpec(s.I, s.J, s.K, s.L)
                          for s in p.light_specs),
        light_power=p.light_power, flip_winding=p.flip_winding)


def _clutter(c, n_extra: int, seed: int) -> tuple:
    """build_scene's arguments for a Cornell box ``c`` (either package's)
    plus `n_extra` small random surface triangles inside it."""
    ns = c.n_surfaces
    rng = np.random.default_rng(seed)
    cen = rng.uniform(-0.9, 0.9, (n_extra, 3)).astype(np.float32)
    tri = cen[:, None, :] + rng.normal(0, 0.03, (n_extra, 3, 3)).astype(
        np.float32)
    rgb = rng.uniform(0.1, 0.9, (n_extra, 3)).astype(np.float32)
    a = np.asarray
    return (np.concatenate([a(c.v0)[:ns], tri[:, 0]]),
            np.concatenate([a(c.v1)[:ns], tri[:, 1]]),
            np.concatenate([a(c.v2)[:ns], tri[:, 2]]),
            np.concatenate([a(c.diffuse_c)[:ns], rgb]),
            a(c.v0)[ns:], a(c.v1)[ns:], a(c.v2)[ns:], a(c.emission)[ns:])


def cornell_plus_clutter(n_extra: int = 250, seed: int = 7):
    """The Cornell box plus `n_extra` small random surface triangles inside
    it (JAX scene): 288 triangles pad to 512, two 256-triangle chunks, so
    the JAX launcher takes its streaming multi-chunk (AABB-culled) path."""
    return jax_build_scene(*_clutter(jax_cornell_box(), n_extra, seed))


def clutter_scene(device="cpu"):
    """cornell_plus_clutter built by the port alone, on ``device``."""
    return build_scene(*_clutter(cornell_box(device="cpu"), 250, 7),
                       device=device)


def skewed_q(t_pad: int, uv_bins: int, skew: float, device="cpu",
             sector_grid: int = 11):
    """The initial binned Q (G x G sectors, radiance 100/G^2) skewed per
    entry by exp(skew * U[0, 1)) from numpy seed 3."""
    q, _ = init_bin_q(t_pad, uv_bins, sector_grid, 100.0 / sector_grid ** 2,
                      device="cpu")
    u = np.random.default_rng(3).random(q.shape)
    return (q * torch.from_numpy(np.exp(skew * u).astype(np.float32))).to(
        device)


def assert_frame_parity(img_t, aux_t, img_j, aux_j):
    """Per-pixel parity of two renders that draw the same samples.

    Only paths where f32 rounding flips a hit (or, guided, a uv bin) may
    differ: throughput factors are bitwise identical on both sides, and
    geometry differs in the last ulp (classic vs matmul Moller-Trumbore,
    FMA contraction, cos/sin).  So: >= 99% of pixels within atol 1e-4,
    rtol 1e-3; frame mean within 0.5%; avg path length within 1%.
    """
    img_t = np.asarray(img_t)
    img_j = np.asarray(img_j)
    assert img_t.shape == img_j.shape
    assert np.isfinite(img_t).all()
    close = np.isclose(img_t, img_j, atol=1e-4, rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    mt, mj = float(img_t.mean()), float(img_j.mean())
    assert abs(mt - mj) <= 0.005 * mj, (mt, mj)
    at, aj = float(aux_t["avg_path_length"]), float(aux_j["avg_path_length"])
    assert abs(at - aj) <= 0.01 * aj, (at, aj)


def hold_to_jax(img, jax_frames):
    """Hold a frame to K JAX frames of other seeds.  Pixels are
    independent, so the variance of a mean over pixels is the sum of the
    pixels' variances (each from the K frames) over the count squared; a
    new frame spreads from the K frames' average by sqrt(1 + 1/K) of one
    frame's deviation.  Ranges below are of test_torch_deep_q.py's six
    Cornell cases, port frames of 4 seeds and JAX frames of 4 seeds
    outside the K:

    * the frame mean within 4 standard deviations of JAX's (port and JAX
      within 2.3; a frame at half brightness lies 9.6-11 below, a black
      one 19-23);
    * the 3x3 block means' squared z, averaged, below 8 (port 0.4-4.3,
      JAX 0.4-6.4, where a firefly lands in one block; half 16-19;
      radiance banked into a slot's first pixel 34-40);
    * the mean absolute pixel distance from JAX's average frame at most
      1.3x the median of each JAX frame's distance from the others'
      average (port 0.89-1.15, JAX 0.93-1.15; a frame three rows off
      2.5-4.1x).
    A per-bounce throughput 0.7x too small lies 2-5 standard deviations
    low: at this size, the frame holds gross faults only; the per-bounce
    factor is held by test_sample_directions_on_jax_uniforms."""
    k = len(jax_frames)
    grow = np.sqrt(1.0 + 1.0 / k)
    js = np.stack([np.asarray(j).astype(np.float64) for j in jax_frames])
    x = img.numpy().astype(np.float64)
    var = js.mean(-1).var(0, ddof=1)           # per pixel, one frame's
    b = var.shape[0] // 3

    def blocks(a):
        return a.mean(-1).reshape(a.shape[:-3] + (3, b, 3, b)).mean((-3, -1))

    z = (x.mean() - js.mean()) / (np.sqrt(var.sum()) / var.size * grow)
    block_var = var.reshape(3, b, 3, b).sum((1, 3)) / (b * b) ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        z2 = (blocks(x) - blocks(js).mean(0)) ** 2 / (block_var * grow ** 2)
    chi2 = np.mean(np.where(np.isnan(z2), 0.0, z2))  # 0/0: a fixed block
    total = js.sum(0)
    own = np.median([np.abs(js[i] - (total - js[i]) / (k - 1)).mean()
                     for i in range(k)])
    dist = np.abs(x - total / k).mean() / own
    assert x.max() > 0 and x.mean() > 0, "black frame"
    assert abs(z) < 4.0, (z, x.mean(), js.mean())
    assert chi2 < 8.0, chi2
    assert dist <= 1.3, dist
