"""The BVH build kernel's plain version (rlrpt_tpu_torch/ops/bvh.py:
build_bvh_plain, the level steps of csrc/bvh_build.cu in torch float64)
held bit for bit against the numpy build (``_build_host``, the tree's
definition): the nodes' bits, order, tris_sorted and depth.  On the card
(``-m chip``) the kernel is held to both on every table below and on
soups of up to 20,000 triangles.  The JAX package builds no tree (its
culled megakernel computes 256-triangle chunk boxes instead), so no case
here runs JAX.

Tables: the Cornell box, the test room, the Cornell box plus 250 small
triangles (``clutter_scene``), and the generated torus room at bunny.obj's
size (4,980 triangles), also Morton-sorted; T in {0, 1, 4, 5}; triangles
whose centroids all coincide; zero-area triangles; duplicated triangles;
negative zeros; and triangle soups drawn by hypothesis.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from rlrpt_tpu_torch import _cuda
from rlrpt_tpu_torch.ops import bvh as bv
from rlrpt_tpu_torch.ops import intersect_pallas as ip
from rlrpt_tpu_torch.scene import generated, presets
from rlrpt_tpu_torch.scene.scene import morton_sort_surfaces
from _torch_parity import card, clutter_scene, one_torch_thread  # noqa: F401


def _rows(v0, v1, v2):
    """(T, 12) f32 pack_triangles rows of numpy corner arrays."""
    v0, v1, v2 = (np.asarray(a, np.float32).reshape(-1, 3)
                  for a in (v0, v1, v2))
    z = np.zeros((v0.shape[0], 1), np.float32)
    return torch.from_numpy(np.concatenate([v0, z, v1 - v0, z, v2 - v0, z],
                                           axis=1))


def _coincident(n, seed):
    """n triangles c + (a, b, -a - b) on a 1/64 grid: every centroid is c
    exactly."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-64, 64, (n, 3)) / 64.0
    b = rng.integers(-64, 64, (n, 3)) / 64.0
    c = np.array([0.25, -0.5, 0.125])
    return _rows(c + a, c + b, c - a - b)


def _edge_table(name):
    rng = np.random.default_rng(5)
    soup = rng.normal(size=(40, 3, 3))
    if name.startswith("soup"):
        n = int(name[4:])
        return _rows(soup[:n, 0], soup[:n, 1], soup[:n, 2])
    if name == "coincident_5":
        return _coincident(5, 1)
    if name == "coincident_40":
        return _coincident(40, 2)
    if name == "one_triangle_x12":
        return _rows(*np.repeat(soup[:1].transpose(1, 0, 2), 12, axis=1))
    if name == "zero_area":   # points and collinear triangles
        p = rng.normal(size=(20, 3))
        q = rng.normal(size=(20, 3))
        return _rows(np.r_[p, p], np.r_[p, q], np.r_[p, 0.5 * (p + q)])
    if name == "duplicated":
        both = np.concatenate([soup, soup, soup[:7]])
        return _rows(both[:, 0], both[:, 1], both[:, 2])
    if name == "negative_zeros":
        z = np.zeros((9, 3), np.float32)
        return _rows(-z, z, -z)
    raise KeyError(name)


EDGE = ("soup0", "soup1", "soup4", "soup5", "coincident_5", "coincident_40",
        "one_triangle_x12", "zero_area", "duplicated", "negative_zeros")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """name -> (T, 12) f32 table of a scene."""
    torus = generated.torus_room(
        tmp_path_factory.mktemp("torus") / "torus_room.obj",
        *generated.BUNNY_SIZE)
    out = {name: ip.pack_triangles(presets.load_scene(name, device="cpu"))
           for name in ("cornell", "test_room")}
    out["clutter"] = ip.pack_triangles(clutter_scene())
    room = torus.load(device="cpu")
    out["torus_room"] = ip.pack_triangles(room)
    out["torus_room_morton"] = ip.pack_triangles(morton_sort_surfaces(room))
    return out


def _assert_same(a: bv.Bvh, b: bv.Bvh) -> None:
    """The same tree bit for bit, on any devices."""
    bits = lambda t: t.cpu().view(torch.int32)  # noqa: E731
    assert a.nodes.shape == b.nodes.shape
    assert torch.equal(bits(a.nodes), bits(b.nodes))
    assert a.order.dtype == b.order.dtype == torch.int32
    assert torch.equal(a.order.cpu(), b.order.cpu())
    assert torch.equal(bits(a.tris_sorted), bits(b.tris_sorted))
    assert a.depth == b.depth


@pytest.mark.parametrize("name", ["cornell", "test_room", "clutter",
                                  "torus_room"])
def test_plain_equals_numpy_on_scenes(scenes, name):
    tris = scenes[name]
    levels = []
    plain = bv.build_bvh_plain(tris, levels)
    _assert_same(plain, bv.build_bvh(tris))
    # every inner node is split once: one (nodes, triangles) pair a level
    assert len(levels) == plain.depth
    assert sum(k for k, _ in levels) == plain.nodes.shape[0]
    assert levels[0] == (1, tris.shape[0])
    if name == "torus_room":
        assert tris.shape[0] == 4980 and plain.depth <= bv.STACK


@pytest.mark.parametrize("name", EDGE)
def test_plain_equals_numpy_on_edge_cases(name):
    tris = _edge_table(name)
    plain = bv.build_bvh_plain(tris)
    _assert_same(plain, bv.build_bvh(tris))
    if tris.shape[0] <= bv.LEAF_MAX:
        assert plain.nodes.shape[0] == 1 and plain.depth == 1
    if name.startswith("coincident"):
        # every centroid at one point: a split by index at each level
        assert plain.depth == int(np.ceil(np.log2(tris.shape[0] / 4)))


def _soup(n, grid=0):
    """n triangles of normal corners (numpy seed n), on a 1/grid grid when
    ``grid`` (ties in the bins and the SAH costs)."""
    c = np.random.default_rng(n).normal(size=(n, 3, 3))
    if grid:
        c = np.round(c * grid) / grid
    return _rows(c[:, 0], c[:, 1], c[:, 2])


SOUPS = {"normal_37": (37, 0), "grid8_300": (300, 8),
         "normal_2000": (2000, 0), "grid16_20000": (20000, 16)}


@pytest.mark.chip
@pytest.mark.parametrize("name", ["cornell", "test_room", "clutter",
                                  "torus_room", "torus_room_morton", *EDGE,
                                  *SOUPS])
def test_kernel_builds_the_numpy_tree_on_the_card(card, scenes, name):
    """build_bvh on a CUDA table (the build kernel) gives the numpy
    build's and build_bvh_plain's tree, bit for bit."""
    tris = (scenes[name] if name in scenes else
            _soup(*SOUPS[name]) if name in SOUPS else _edge_table(name))
    host = bv.build_bvh(tris)
    _assert_same(bv.build_bvh_plain(tris), host)
    before = bv.KERNEL_BUILD.launches
    kern = bv.build_bvh(tris.to(card))
    assert bv.KERNEL_BUILD.launches == before + 1
    assert kern.nodes.device.type == "cuda"
    _assert_same(kern, host)


@settings(max_examples=100, deadline=None)
@given(hnp.arrays(np.float32, st.tuples(st.integers(0, 48), st.just(3),
                                        st.just(3)),
                  elements=st.floats(-8.0, 8.0, width=32)))
def test_plain_equals_numpy_on_drawn_soups(corners):
    tris = _rows(corners[:, 0], corners[:, 1], corners[:, 2])
    _assert_same(bv.build_bvh_plain(tris), bv.build_bvh(tris))


def test_cpu_build_never_touches_the_kernel(scenes, monkeypatch):
    """build_bvh on a CPU table is the numpy build: neither the wrapper
    nor the library is reached."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA build was reached for a CPU table")

    monkeypatch.setattr(bv, "launch_build", refuse)
    monkeypatch.setattr(_cuda, "library", refuse)
    before = bv.KERNEL_BUILD.launches
    tris = scenes["clutter"]
    _assert_same(bv.build_bvh(tris), bv.build_bvh_plain(tris))
    assert bv.KERNEL_BUILD.launches == before


def test_wrapper_raises_for_other_devices(scenes):
    """The kernel's wrapper takes CUDA tables only, and build_bvh a CPU or
    a CUDA table: another device raises before anything launches."""
    before, builds = bv.KERNEL_BUILD.launches, bv.BUILDS
    meta = torch.empty((10, 12), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="device"):
        bv.build_bvh(meta)
    with pytest.raises(ValueError, match="device"):
        bv.launch_build(meta)
    with pytest.raises(ValueError, match="device"):
        bv.launch_build(scenes["cornell"])
    with pytest.raises(ValueError, match="CPU"):
        bv.build_bvh_plain(meta)
    assert bv.KERNEL_BUILD.launches == before and bv.BUILDS == builds


def test_plain_raises_beyond_stack(scenes, monkeypatch):
    tris = scenes["clutter"]
    depth = bv.build_bvh_plain(tris).depth
    monkeypatch.setattr(bv, "STACK", depth - 1)
    with pytest.raises(ValueError, match="stack"):
        bv.build_bvh_plain(tris)


def test_walk_simt_counts_need_the_card(scenes):
    """walk_counts' SIMT counters come from the card's warps: on CPU
    tables it refuses them and still gives the twin's visits and tests."""
    from rlrpt_tpu_torch.config import RenderConfig
    from rlrpt_tpu_torch.ops import megakernel as mk
    tris, mat = mk.pack_scene(clutter_scene())
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                       max_ray_bounces=4)
    args = (3, (0.0, 0.0, -3.0, 1.0, 0.0, 1.0, 0.0), tris, mat, cfg,
            mk.n_slots_for(cfg.n_pixels, mk.R_TILE, mk.PIX_MUX), mk.PIX_MUX,
            bv.build_bvh(tris))
    with pytest.raises(ValueError, match="card"):
        mk.walk_counts(*args, simt=True)
    visits, tests = mk.walk_counts(*args)
    assert visits > 0 and tests > 0
