"""rlrpt_tpu_torch scenes vs rlrpt_tpu: the OBJ importer (Python and
native), the preset registry, the test room, Morton order, and frames of
the generated OBJ scene and the test room against the JAX kernels in
interpret mode.

OBJ files are written by the tests: inline text, and the generated torus
room (``rlrpt_tpu_torch/scene/generated.py``) at ~300 triangles (two
256-triangle tiles).  The reference's own models are not needed.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rlrpt_tpu import config as jconfig
from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.ops import guided_mega as jgm
from rlrpt_tpu.ops import guided_mega_train as jgt
from rlrpt_tpu.ops import megakernel as jmk
from rlrpt_tpu.scene import cornell as jcornell
from rlrpt_tpu.scene import obj_importer as jobj
from rlrpt_tpu.scene import presets as jpresets
from rlrpt_tpu.scene.scene import morton_sort_surfaces as jax_morton
from rlrpt_tpu.utils import native as jnative
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.ops import guided_mega as gm
from rlrpt_tpu_torch.ops import guided_mega_train as gt
from rlrpt_tpu_torch.ops import megakernel as mk
from rlrpt_tpu_torch.scene import cornell, generated, obj_importer, presets
from rlrpt_tpu_torch.scene.scene import morton_sort_surfaces
from rlrpt_tpu_torch.utils import native
from rlrpt_tpu_torch.utils.convert import tri_bin_cdf_from_numpy
from _torch_parity import (assert_frame_parity, jax_preset,  # noqa: F401
                           kernel_seed, one_torch_thread, torch_scene)

FIELDS = ("v0", "v1", "v2", "normal", "diffuse_c", "emission", "luminance")

# Two quads (one with x/x/x tokens), a pentagon and a triangle; dyadic
# coordinates, so float32 and float64 parses agree exactly.
OBJ_TEXT = """# inline test model
o quads
v 0 0 0
v 1 0 0
v 1 0 1
v 0 0 1
v 0 1 0
v 1 1 0
v 0.5 0.75 1.25
v -0.25 0.5 0.125
vt 0 0
vn 0 1 0
f 1 4 3 2
f 5/1/1 6/1/1 3/1/1 4/1/1
f 1 2 6 5 8
s off
f 7 3 4
"""
# 2 + 2 + 3 + 1 = 8 triangles
RED, BLUE = (0.75, 0.15, 0.15), (0.15, 0.15, 0.75)
CASES = {
    "quads_default": dict(),
    "material_rules": dict(material_rules=((1, 2, RED), (2, 6, BLUE)),
                           default_rgb=(0.5, 0.5, 0.25)),
    "light_quads": dict(light_specs=(((0.5, 1.5, 1.5), (1.5, 1.5, 1.5),
                                      (0.5, 1.5, 0.5), (1.5, 1.5, 0.5)),
                                     ((0.25, 1.0, 0.25), (0.75, 1.0, 0.25),
                                      (0.25, 0.5, 0.25), (0.75, 0.5, 0.25))),
                        light_power=11.0),
    "light_ranges": dict(light_ranges=((2, 3), (7, 7)),
                         light_range_power=12.0,
                         material_rules=((0, 1, RED),)),
    "flip_winding": dict(flip_winding=True, material_rules=((4, 9, BLUE),)),
}


def _kwargs(case: dict, pkg):
    """The case's keyword arguments with the package's own rule types."""
    kw = dict(case)
    if "material_rules" in kw:
        kw["material_rules"] = tuple(pkg.MaterialRule(*r)
                                     for r in kw["material_rules"])
    if "light_specs" in kw:
        kw["light_specs"] = tuple(pkg.LightSpec(*s) for s in kw["light_specs"])
    if "light_ranges" in kw:
        kw["light_ranges"] = tuple(pkg.LightRange(*r)
                                   for r in kw["light_ranges"])
    return kw


def assert_scenes_equal(s_t, s_j):
    assert s_t.n_surfaces == s_j.n_surfaces
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(s_t, f).numpy(),
                                      np.asarray(getattr(s_j, f)), err_msg=f)


@pytest.fixture(scope="module")
def small_torus(tmp_path_factory):
    """The generated torus room at 12 x 12 quads: 288 + 10 + 2 = 300
    triangles, padded to 512 (two tiles)."""
    return generated.torus_room(
        tmp_path_factory.mktemp("torus") / "torus_12x12.obj", 12, 12)


# ---- importer -------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_obj_scene_matches_jax(tmp_path, case):
    path = tmp_path / "m.obj"
    path.write_text(OBJ_TEXT)
    s_t = obj_importer.load_obj_scene(
        str(path), **_kwargs(CASES[case], obj_importer), device="cpu")
    s_j = jobj.load_obj_scene(str(path), **_kwargs(CASES[case], jobj))
    assert_scenes_equal(s_t, s_j)
    n_light = s_t.n_triangles - s_t.n_surfaces
    assert n_light == {"light_quads": 4, "light_ranges": 3}.get(case, 0)


def test_parse_obj_matches_jax(tmp_path):
    """Fan triangulation and x/x/x tokens: 1-based faces (i0, ik, ik+1)."""
    path = tmp_path / "m.obj"
    path.write_text(OBJ_TEXT)
    v_t, f_t = obj_importer.parse_obj(str(path))
    v_j, f_j = jobj.parse_obj(str(path))
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(f_t, f_j)
    assert f_t.tolist() == [[1, 4, 3], [1, 3, 2], [5, 6, 3], [5, 3, 4],
                            [1, 2, 6], [1, 6, 5], [1, 5, 8], [7, 3, 4]]
    np.testing.assert_array_equal(obj_importer.normalise_vertices(v_t),
                                  jobj.normalise_vertices(v_j))


def test_native_matches_python(tmp_path, small_torus):
    """The native parse normalises in float32: equal to the Python parse
    after the cast to float32 exactly on float32-exact coordinates (the
    generated scene), within one float32 ulp on decimal ones."""
    assert native.have_native(), native.build_error()
    v_n, f_n = native.parse_obj_native(small_torus.obj)
    v_p, f_p = obj_importer.parse_obj(small_torus.obj)
    np.testing.assert_array_equal(
        v_n, obj_importer.normalise_vertices(v_p).astype(np.float32))
    np.testing.assert_array_equal(f_n, f_p)
    assert len(f_n) == 2 * 12 * 12 + 10

    path = tmp_path / "decimal.obj"
    rng = np.random.default_rng(6)
    path.write_text("".join(f"v {x:.7f} {y:.7f} {z:.7f}\n"
                            for x, y, z in rng.uniform(-2, 3, (50, 3)))
                    + "f 1 2 3 4\nf 5/5/5 6/6/6 7/7/7\n")
    v_n, f_n = native.parse_obj_native(str(path))
    raw, f_p = obj_importer.parse_obj(str(path))
    v_p = obj_importer.normalise_vertices(raw).astype(np.float32)
    # the float32 parse rounds 2x by up to an ulp of 2x, the float32 sum
    # and the final cast by half an ulp of the result each
    ulps = (np.spacing(np.abs(2.0 * raw).astype(np.float32))
            + np.spacing(np.abs(v_p)))
    assert np.all(np.abs(v_n - v_p) <= ulps)
    assert (v_n != v_p).any()   # decimal text does round differently
    np.testing.assert_array_equal(f_n, f_p)
    with pytest.raises(FileNotFoundError):
        native.parse_obj_native(str(tmp_path / "missing.obj"))


def test_native_matches_jax_native(tmp_path, small_torus):
    """One source, two builds: the port's library and the JAX package's
    give equal arrays and byte-equal files."""
    assert native.have_native() and jnative.have_native()
    for path in (small_torus.obj,):
        for a, b in zip(native.parse_obj_native(path),
                        jnative.parse_obj_native(path)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    pos = rng.random((9, 3), np.float32)
    q = rng.random((9, 16), np.float32)
    assert native.save_q_table_native(str(tmp_path / "t.txt"), pos, q)
    assert jnative.save_q_table_native(str(tmp_path / "j.txt"), pos, q)
    read = lambda name: (tmp_path / name).read_bytes()  # noqa: E731
    assert read("t.txt") == read("j.txt")
    for a, b in zip(native.load_q_table_native(str(tmp_path / "j.txt")),
                    jnative.load_q_table_native(str(tmp_path / "t.txt"))):
        np.testing.assert_array_equal(a, b)
    img = rng.integers(0, 256, (7, 11, 3), dtype=np.uint8)
    assert native.write_bmp_native(str(tmp_path / "t.bmp"), img)
    assert jnative.write_bmp_native(str(tmp_path / "j.bmp"), img)
    assert read("t.bmp") == read("j.bmp")


def test_generated_scene_faces_the_camera(tmp_path):
    """bunny.obj's face count, no degenerate triangle, every normal into
    the room and out of the torus, native and Python loads equal."""
    p = generated.torus_room(tmp_path / "torus.obj")
    v, f = obj_importer.parse_obj(p.obj)
    assert len(f) == 2 * 46 * 54 + 10 and 2 * 46 * 54 == 4968
    s = p.load(device="cpu")
    assert (s.n_triangles, s.n_surfaces) == (4980, 4978)
    v0, v1, v2, n = (getattr(s, a).double().numpy()
                     for a in ("v0", "v1", "v2", "normal"))
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    assert area.min() > 1e-4
    cen = (v0 + v1 + v2) / 3.0
    room = slice(0, 10)
    assert np.all(np.einsum("ij,ij->i", n[room], -cen[room]) > 0.5)
    # the torus: the normal points away from the nearest point of the
    # tube's centre circle
    torus = slice(10, s.n_surfaces)
    ring_c = np.array([0.5, 0.42, 0.55]) * 2.0 - 1.0
    tilt = np.radians(35.0)
    axis = np.array([0.0, np.cos(tilt), -np.sin(tilt)])
    flip = np.array([-1.0, -1.0, 1.0])
    ring_c, axis = ring_c * flip, axis * flip
    rel = cen[torus] - ring_c
    radial = rel - (rel @ axis)[:, None] * axis
    core = 2 * 0.27 * radial / np.linalg.norm(radial, axis=1, keepdims=True)
    out = (rel - core) / np.linalg.norm(rel - core, axis=1, keepdims=True)
    assert np.all(np.einsum("ij,ij->i", n[torus], out) > 0.5)
    # the Python path gives the same float32 scene
    py = obj_importer.parse_obj(p.obj)
    np.testing.assert_array_equal(
        native.parse_obj_native(p.obj)[0],
        obj_importer.normalise_vertices(py[0]).astype(np.float32))


# ---- built-in scenes, Morton order, presets -------------------------------

@pytest.mark.parametrize("name", ["cornell", "test_room"])
def test_builtin_scene_matches_jax(name):
    s_t = presets.load_scene(name, device="cpu")
    s_j = jpresets.load_scene(name)
    assert_scenes_equal(s_t, s_j)
    if name == "test_room":
        assert (s_t.n_surfaces, s_t.n_triangles) == (16, 18)
        np.testing.assert_array_equal(s_t.emission[16:].numpy(),
                                      [[5.0, 5.0, 4.5]] * 2)


def test_polygon_light_matches_jax():
    quad = [(0.0, 1.0, 0.0), (1.0, 1.0, 0.0), (1.0, 1.0, 1.0),
            (0.5, 1.0, 1.5), (0.0, 1.0, 1.0)]
    assert cornell.polygon_light(quad) == jcornell.polygon_light(quad, None)
    assert len(cornell.polygon_light(quad)) == 3


@pytest.mark.parametrize("which", ["cornell", "torus"])
def test_morton_order_matches_jax(which, small_torus):
    if which == "cornell":
        s_t = presets.load_scene("cornell", device="cpu")
        s_j = jpresets.load_scene("cornell")
    else:
        s_t = small_torus.load(device="cpu")
        s_j = jax_preset(small_torus).load()
    m_t, m_j = morton_sort_surfaces(s_t), jax_morton(s_j)
    assert_scenes_equal(m_t, m_j)
    # a permutation of the surfaces; the lights stay at the tail
    ns = s_t.n_surfaces
    np.testing.assert_array_equal(m_t.v0[ns:].numpy(), s_t.v0[ns:].numpy())
    assert sorted(map(tuple, m_t.v0[:ns].tolist())) == sorted(
        map(tuple, s_t.v0[:ns].tolist()))


def test_preset_registry_matches_jax():
    assert list(presets.PRESETS) == list(jpresets.PRESETS)
    assert len(presets.PRESETS) == 11
    for name, p in presets.PRESETS.items():
        j = jpresets.get(name)
        names = [f.name for f in dataclasses.fields(p)]
        assert names == [f.name for f in dataclasses.fields(j)]
        for f in names:
            a, b = getattr(p, f), getattr(j, f)
            if f == "builder":
                assert (a is None) == (b is None)
                assert a is None or a.__name__ == b.__name__
            elif f in ("material_rules", "light_specs", "light_ranges"):
                assert [dataclasses.astuple(x) for x in a] == [
                    dataclasses.astuple(x) for x in b], (name, f)
            else:
                assert a == b, (name, f)


@pytest.mark.parametrize("name", [n for n, p in jpresets.PRESETS.items()
                                  if p.obj is not None])
def test_missing_model_raises(name, tmp_path, monkeypatch):
    monkeypatch.setattr(presets, "MODELS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="RLRPT_MODELS_DIR") as e:
        presets.load_scene(name, device="cpu")
    assert str(tmp_path / presets.get(name).obj) in str(e.value)


def test_preset_loads_absolute_obj_path(small_torus, tmp_path, monkeypatch):
    """An absolute obj path ignores the models directory, as in JAX."""
    monkeypatch.setattr(presets, "MODELS_DIR", str(tmp_path / "none"))
    assert_scenes_equal(small_torus.load(device="cpu"),
                        jax_preset(small_torus).load())


# ---- frames on the new scenes ---------------------------------------------

def test_generated_frame_matches_jax(small_torus):
    """The 300-triangle OBJ (two tiles) through B1's twin and the JAX
    megakernel (interpret mode, its multi-chunk path), per pixel."""
    cfg = dict(width=16, height=16, samples_per_pixel=2, max_ray_bounces=80)
    key = jax.random.PRNGKey(6)
    s_j = jax_preset(small_torus).load()
    assert jmk._t_pad(s_j.n_triangles) == 2 * jmk.T_CHUNK
    cam = small_torus.camera_position
    img_j, aux_j = jmk.render_default_mega(
        key, s_j, JCamera.create(cam), jconfig.RenderConfig(**cfg),
        r_tile=128, pix_mux=2, interpret=True, precision="highest")
    img_t, aux_t = mk.render_default_mega(
        kernel_seed(key), small_torus.load(device="cpu"), Camera.create(cam),
        RenderConfig(**cfg), device="cpu", r_tile=128, pix_mux=2)
    assert_frame_parity(img_t, aux_t, img_j, aux_j)
    assert float(img_t.max()) > 0 and float(aux_t["avg_path_length"]) > 2.0


def test_test_room_frame_matches_jax():
    cfg = dict(width=24, height=24, samples_per_pixel=4, max_ray_bounces=10)
    key = jax.random.PRNGKey(3)
    img_j, aux_j = jmk.render_default_mega(
        key, jpresets.load_scene("test_room"), JCamera.create((0, 0, -3.0)),
        jconfig.RenderConfig(**cfg), r_tile=128, pix_mux=4, interpret=True,
        precision="highest")
    img_t, aux_t = mk.render_default_mega(
        kernel_seed(key), presets.load_scene("test_room", device="cpu"),
        Camera.create((0.0, 0.0, -3.0)), RenderConfig(**cfg), device="cpu",
        r_tile=128, pix_mux=4)
    assert_frame_parity(img_t, aux_t, img_j, aux_j)


def test_test_room_learning_frame_matches_jax():
    """Two binned learning frames on the test room (18 triangles, t_pad
    24), held to JAX's as tests/test_torch_guided_mega_train.py holds the
    Cornell box's."""
    g, uv, t_pad = 11, 4, 24
    rl = RadianceVolumeConfig(grid_resolution=g)
    kw = dict(width=32, height=32, samples_per_pixel=4, max_ray_bounces=6)
    scene_j = jpresets.load_scene("test_room")
    scene_t = torch_scene(scene_j)
    assert mk._t_pad(scene_t.n_triangles) == t_pad
    qj, vj = jgt.init_bin_q(t_pad, uv, g, rl.initial_radiance)
    qt, vt = torch.from_numpy(np.array(qj)), torch.from_numpy(np.array(vj))
    for f in range(2):
        tj = jgt.rebuild_bin_cdf(qj, g, uv, t_pad)
        tt = tri_bin_cdf_from_numpy(np.asarray(tj.cdf, np.float32), g, uv,
                                    t_pad)
        key = jax.random.PRNGKey(40 + f)
        img_j, qj2, vj2, aux_j = jgt.render_sarsa_mega_train(
            key, scene_j, JCamera.create((0, 0, -3.0)), tj, qj, vj,
            jconfig.RenderConfig(**kw), rl.radiance_threshold, r_tile=512,
            pix_mux=2, interpret=True, precision="highest")
        img_t, qt2, vt2, aux_t = gt.render_sarsa_mega_train(
            kernel_seed(key), scene_t, Camera.create((0.0, 0.0, -3.0)), tt,
            qt, vt, RenderConfig(**kw), rl.radiance_threshold, device="cpu",
            r_tile=512, pix_mux=2)
        assert_frame_parity(img_t, aux_t, img_j, aux_j)
        td_t, td_j = int(aux_t["td_scatter_count"]), int(aux_j[
            "td_scatter_count"])
        assert abs(td_t - td_j) <= 0.005 * td_j, (td_t, td_j)
        assert float((vt2 - vt).sum()) == td_t
        assert float(np.asarray(vj2 - vj).sum()) == td_j
        va, vb = np.asarray(vj2), vt2.numpy()
        assert (va == vb).mean() >= 0.99, (va == vb).mean()
        qa, qb = np.asarray(qj2)[:g * g], qt2.numpy()[:g * g]
        for rtol, share in ((1e-3, 0.98), (1e-1, 0.99)):
            assert np.isclose(qb, qa, rtol=rtol, atol=0.0).mean() >= share
        qj, vj, qt, vt = qj2, vj2, qt2, vt2


def test_multi_tile_binned_limits_match_jax(small_torus):
    """The binned learning kernel takes single-chunk scenes only, and a
    multi-chunk guided render needs a per-triangle (uv_bins 1) table: both
    packages refuse alike."""
    s_t = small_torus.load(device="cpu")
    s_j = jax_preset(small_torus).load()
    t_pad = mk._t_pad(s_t.n_triangles)
    cfg = dict(width=8, height=8, samples_per_pixel=1, max_ray_bounces=2)
    cam = small_torus.camera_position
    q, v = gt.init_bin_q(t_pad, 4, 11, 1.0, device="cpu")
    table = gt.rebuild_bin_cdf(q, 11, 4, t_pad)
    qj, vj = jgt.init_bin_q(t_pad, 4, 11, 1.0)
    table_j = jgt.rebuild_bin_cdf(qj, 11, 4, t_pad)
    with pytest.raises(ValueError, match="single-chunk"):
        gt.render_sarsa_mega_train(0, s_t, Camera.create(cam), table, q, v,
                                   RenderConfig(**cfg), 0.01, device="cpu")
    with pytest.raises(ValueError, match="single-chunk"):
        jgt.render_sarsa_mega_train(
            jax.random.PRNGKey(0), s_j, JCamera.create(cam), table_j, qj, vj,
            jconfig.RenderConfig(**cfg), 0.01, interpret=True)
    with pytest.raises(ValueError, match="PER-TRIANGLE"):
        gm.render_guided_mega(0, s_t, Camera.create(cam), table,
                              RenderConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match="PER-TRIANGLE"):
        jgm.render_guided_mega(jax.random.PRNGKey(0), s_j, JCamera.create(cam),
                               table_j, jconfig.RenderConfig(**cfg),
                               interpret=True)
