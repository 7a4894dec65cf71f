"""The host helpers' table cache (rlrpt_tpu_torch/utils/prep_cache.py): the
packed scene, the bins' luminance, the sector cosines and the concentric
map's up vector are built once and handed out again, bit for bit what a
fresh build gives, until a source tensor or the table itself is written
or a source dies.

The test marked ``chip`` needs a CUDA card and skips without one: a
learning job waits for the card only in ``check_cdf``, once a frame, and
a default render not at all.
"""

import collections
import dataclasses
import gc
import warnings
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.ops import guided_mega as gm
from rlrpt_tpu_torch.ops import guided_mega_train as gt
from rlrpt_tpu_torch.ops import hemisphere as hs
from rlrpt_tpu_torch.ops import intersect_pallas as ip
from rlrpt_tpu_torch.ops import megakernel as mk
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.utils import prep_cache, profiling
from _torch_parity import card  # noqa: F401

G, UV, T_PAD = 11, 4, 40          # the Cornell box: 38 triangles
CAM = Camera.create([0.0, 0.0, -3.0])
RL = RadianceVolumeConfig(grid_resolution=G)

# table -> (the cached call, a fresh build) on a scene
TABLES = {
    "pack": (mk.pack_scene, mk._pack_scene),
    "bin_lum": (lambda s: gt.bin_luminance(s, T_PAD, UV),
                lambda s: gt._bin_luminance(s, T_PAD, UV)),
    "sector_cos": (lambda s: hs.sector_cos_thetas(G, s.device),
                   lambda s: hs.sector_centre_dirs_local(G, s.device)[:, 1]),
}


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.RECORDER.reset()
    yield
    profiling.RECORDER.reset()


def _tensors(value):
    return value if isinstance(value, tuple) else (value,)


def _bits(t):
    return t.reshape(-1).contiguous().view(torch.uint8)


def _bit_equal(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(_bits(x), _bits(y))
               for x, y in zip(_tensors(a), _tensors(b), strict=True))


def _recorded(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


@pytest.mark.parametrize("table", list(TABLES))
def test_a_table_is_its_fresh_build_bit_for_bit(table):
    cached, fresh = TABLES[table]
    scene = cornell_box(device="cpu")
    prep_cache.CACHE.clear()
    cold = cached(scene)
    warm = cached(scene)
    assert _bit_equal(cold, fresh(scene.to("cpu")))
    assert _bit_equal(warm, fresh(scene))
    assert all(t.is_contiguous() for t in _tensors(warm))


@pytest.mark.parametrize("table", list(TABLES))
def test_a_second_call_hits_also_through_scene_to(table):
    cached, _ = TABLES[table]
    scene = cornell_box(device="cpu")
    first = _recorded(lambda: cached(scene))
    again = _recorded(lambda: cached(scene.to("cpu")))
    again2 = _recorded(lambda: cached(scene.to(torch.device("cpu"))))
    for a, b, c in zip(_tensors(first), _tensors(again), _tensors(again2)):
        assert a is b is c
    rec = profiling.RECORDER
    assert rec.lookups[table] == 3 and rec.hits[table] >= 2


@pytest.mark.parametrize("field,table", [
    ("v0", "pack"), ("diffuse_c", "pack"), ("luminance", "pack"),
    ("luminance", "bin_lum")])
def test_an_edited_scene_rebuilds(field, table):
    cached, fresh = TABLES[table]
    scene = cornell_box(device="cpu")
    before = cached(scene)
    getattr(scene, field).mul_(0.5)   # in place: the same tensor
    after = _recorded(lambda: cached(scene))
    assert profiling.RECORDER.hits[table] == 0
    assert _bit_equal(after, fresh(scene))
    assert all(a is not b for a, b in zip(_tensors(after), _tensors(before)))
    other = cornell_box(device="cpu")   # equal values, other tensors
    assert all(a is not b for a, b in zip(_tensors(cached(other)),
                                          _tensors(after)))
    assert _bit_equal(cached(other), fresh(other))


def test_a_table_written_by_a_caller_is_rebuilt():
    scene = cornell_box(device="cpu")
    tris, mat = mk.pack_scene(scene)
    mat[0, 0] = 123.0
    tris2, mat2 = mk.pack_scene(scene)
    assert mat2 is not mat and _bit_equal((tris2, mat2),
                                          mk._pack_scene(scene))
    # pack_scene_mxu writes its class column into a copy
    _, mxu = ip.pack_scene_mxu(scene)
    assert mk.pack_scene(scene)[1] is mat2
    assert not mxu[:, 11].any()
    assert torch.equal(mat2[:, 11], torch.arange(scene.n_triangles).float())


def test_a_dropped_scene_frees_its_entries():
    gc.collect()
    n = len(prep_cache.CACHE)
    scene = cornell_box(device="cpu")
    mk.pack_scene(scene)
    gt.bin_luminance(scene, T_PAD, UV)
    assert len(prep_cache.CACHE) == n + 2
    del scene
    gc.collect()
    assert len(prep_cache.CACHE) == n


def test_sources_under_autograd_are_not_cached():
    scene = cornell_box(device="cpu")
    live = dataclasses.replace(
        scene, diffuse_c=scene.diffuse_c.clone().requires_grad_(True))
    n = len(prep_cache.CACHE)
    _, mat = mk.pack_scene(live)
    _, mat2 = mk.pack_scene(live)
    assert mat.requires_grad and mat2 is not mat
    assert len(prep_cache.CACHE) == n
    with torch.no_grad():   # no graph: cached
        assert mk.pack_scene(live)[1] is mk.pack_scene(live)[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_concentric_map_is_the_host_copy_construction(dtype, monkeypatch):
    """The up vector made on the device against the copy from the host it
    replaced, over a grid through the origin (x = y = 0.5)."""
    u = torch.linspace(0.0, 1.0, 41, dtype=dtype)
    x, y = torch.meshgrid(u, u, indexing="ij")
    prep_cache.CACHE.clear()
    new = hs.concentric_map(x, y)
    monkeypatch.setattr(hs, "_up", lambda dt, dev: torch.tensor(
        [0.0, 1.0, 0.0], dtype=dt, device=dev))
    prep_cache.CACHE.clear()
    old = hs.concentric_map(x, y)
    prep_cache.CACHE.clear()
    assert _bit_equal(new, old)
    assert new[20, 20].tolist() == [0.0, 1.0, 0.0]


def _learning_frame(scene):
    q, v = gt.init_bin_q(T_PAD, UV, G, RL.initial_radiance, device="cpu")
    table = gt.rebuild_bin_cdf(q, G, UV, T_PAD)
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=2,
                       max_ray_bounces=4)
    img, q1, v1, aux = gt.render_sarsa_mega_train(
        5, scene, CAM, table, q, v, cfg, RL.radiance_threshold, "cpu")
    table1 = gt.rebuild_bin_cdf(q1, G, UV, T_PAD)
    guided, _ = gm.render_guided_mega(7, scene, CAM, table1, cfg, "cpu")
    return img, q1, v1, aux["td_scatter_count"], table1.cdf, guided


def test_a_learning_frame_is_the_same_cold_and_warm():
    scene = cornell_box(device="cpu")
    prep_cache.CACHE.clear()
    cold = _learning_frame(scene)
    warm = _recorded(lambda: _learning_frame(scene))
    rec = profiling.RECORDER
    assert set(rec.lookups) == {"pack", "bin_lum", "sector_cos"}
    assert rec.hits == rec.lookups
    for a, b in zip(cold, warm, strict=True):
        assert _bit_equal(a, b)


@pytest.mark.chip
def test_a_learning_job_waits_only_in_check_cdf(card):
    """Under torch's sync debug mode, over one learning job (10 learning
    frames each followed by a rebuild, a guided render) and one default
    render on the card: torch sees 11 waits, all in check_cdf, and the
    recorder counts the same; every table lookup hits."""
    dev = card
    cfg = RenderConfig(width=128, height=128, samples_per_pixel=4,
                       max_ray_bounces=80)
    scene = cornell_box(device=dev)

    def job():
        q, v = gt.init_bin_q(T_PAD, UV, G, RL.initial_radiance, device=dev)
        table = gt.rebuild_bin_cdf(q, G, UV, T_PAD)
        for f in range(10):
            _, q, v, _ = gt.render_sarsa_mega_train(
                11 + f, scene, CAM, table, q, v, cfg,
                RL.radiance_threshold, dev)
            table = gt.rebuild_bin_cdf(q, G, UV, T_PAD)
        gm.render_guided_mega(21, scene, CAM, table, cfg, dev)

    def render():
        mk.render_default_mega(3, scene, CAM, cfg, dev)

    job()   # the library's build, every first call and every table
    render()
    torch.cuda.synchronize()
    for fn, waits in ((job, {"check_cdf": 11}), (render, {})):
        profiling.RECORDER.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        seen = collections.Counter(
            Path(w.filename).name for w in caught
            if "synchroniz" in str(w.message))
        rec = profiling.RECORDER
        print(f"{fn.__name__}: torch's sync debug mode {dict(seen)}, "
              f"counted {dict(rec.syncs)}; lookups {dict(rec.lookups)}, "
              f"hits {dict(rec.hits)}")
        assert dict(seen) == ({"guided_mega.py": 11} if waits else {})
        assert dict(rec.syncs) == waits
        assert rec.lookups and rec.hits == rec.lookups
    profiling.RECORDER.reset()
