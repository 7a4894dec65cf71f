"""The closest-hit kernel's bounding-volume hierarchy (rlrpt_tpu_torch/ops/
bvh.py): the build's invariants, and its plain walk held bit for bit
against the brute-force twin ``closest_hit_plain`` (t, index and material
rows), which tests/test_torch_intersect_pallas.py holds against the CUDA
kernel on the card.

Scenes: no triangle, one, two identical ones, the Cornell box, the test
room, the generated torus room at 12 x 12 quads (300 triangles, two
256-triangle tiles) and a random soup.  Rays, made from numpy seeds:
jittered camera rays, one bounce ray per camera hit, rays aimed exactly at
vertices, edges and shared edges, axis-parallel rays (zero direction
components) and rays grazing triangles' planes.  One case holds the walk
against the JAX package's Pallas kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.camera import primary_rays
from rlrpt_tpu.ops import intersect_pallas as jip
from rlrpt_tpu.ops.intersect import closest_hit as jax_closest_hit
from rlrpt_tpu.scene import obj_importer as jobj
from rlrpt_tpu.scene import presets as jpresets
from rlrpt_tpu_torch.camera import Camera, pixel_rays
from rlrpt_tpu_torch.ops import bvh as bv
from rlrpt_tpu_torch.ops import intersect_pallas as ip
from rlrpt_tpu_torch.scene import generated, presets
from _torch_parity import one_torch_thread  # noqa: F401

CAM = (0.0, 0.0, -3.0)
SCENES = ("empty", "one", "two_identical", "cornell", "test_room", "torus",
          "soup")


def _rows(v0, v1, v2):
    """(T, 12) f32 pack_triangles rows of numpy corner arrays."""
    v0, v1, v2 = (np.asarray(a, np.float32).reshape(-1, 3)
                  for a in (v0, v1, v2))
    z = np.zeros((v0.shape[0], 1), np.float32)
    return torch.from_numpy(np.concatenate([v0, z, v1 - v0, z, v2 - v0, z],
                                           axis=1))


def _random_mat(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, (n, 16)).astype(np.float32))


@pytest.fixture(scope="module")
def torus_preset(tmp_path_factory):
    return generated.torus_room(
        tmp_path_factory.mktemp("torus") / "torus_12x12.obj", 12, 12)


@pytest.fixture(scope="module")
def tables(torus_preset):
    """name -> (tris (T, 12), mat (T, 16)) f32 tables."""
    tri = np.array([[-0.5, -0.5, 0.5], [0.5, -0.5, 0.5], [0.0, 0.6, 0.5]],
                   np.float32)
    rng = np.random.default_rng(3)
    cen = rng.uniform(-0.9, 0.9, (400, 1, 3))
    soup = (cen + rng.normal(0, 0.08, (400, 3, 3))).astype(np.float32)
    out = {
        "empty": (_rows(np.zeros((0, 3)), np.zeros((0, 3)),
                        np.zeros((0, 3))), _random_mat(0, 1)),
        "one": (_rows(*tri[:, None]), _random_mat(1, 1)),
        "two_identical": (_rows(*np.repeat(tri[:, None], 2, axis=1)),
                          _random_mat(2, 1)),
        "soup": (_rows(soup[:, 0], soup[:, 1], soup[:, 2]),
                 _random_mat(400, 1)),
    }
    for name, scene in (("cornell", presets.load_scene("cornell",
                                                       device="cpu")),
                        ("test_room", presets.load_scene("test_room",
                                                         device="cpu")),
                        ("torus", torus_preset.load(device="cpu"))):
        out[name] = ip.pack_scene_mxu(scene)
    return out


def _camera_rays(size=48, seed=0):
    jitter = torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, (size, size, 2)).astype(np.float32))
    o, d = pixel_rays(jitter, Camera.create(CAM), size, size, float(size))
    return o.contiguous(), d.contiguous()


def _unit(v):
    v = np.asarray(v, np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _bounce_rays(tris, mat, seed=1):
    """One ray from each camera ray's hit, uniform about the geometric
    normal on the side the camera ray came from, from 1e-4 off the hit."""
    o, d = _camera_rays()
    t, idx = ip.closest_hit_plain(o, d, tris, o.shape[0])
    hit = (t < 1e38).numpy()
    r = tris.numpy()[idx.numpy()]
    n = _unit(np.cross(r[:, 4:7], r[:, 8:11]) + 1e-30)
    dn = d.numpy()
    n = np.where((n * dn).sum(1, keepdims=True) > 0, -n, n)
    nd = _unit(np.random.default_rng(seed).normal(size=dn.shape))
    nd = np.where((nd * n).sum(1, keepdims=True) < 0, -nd, nd)
    o2 = o.numpy() + np.where(hit, t.numpy(), 0)[:, None] * dn + 1e-4 * nd
    return (torch.from_numpy(o2[hit].astype(np.float32)),
            torch.from_numpy(nd[hit].astype(np.float32)))


def _corners(tris):
    r = tris.numpy()
    v0 = r[:, 0:3]
    return v0, v0 + r[:, 4:7], v0 + r[:, 8:11]   # f32 sums


def _edge_rays(tris, seed=2, n_tri=96):
    """Rays aimed exactly at vertices, edge midpoints and points along the
    edges (shared edges included: each of the two triangles' edge points),
    from the camera and from random origins inside the scene."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = _corners(tris)
    pick = rng.choice(v0.shape[0], min(n_tri, v0.shape[0]), replace=False)
    pts = []
    for a, b in ((v0, v1), (v1, v2), (v2, v0)):
        a, b = a[pick], b[pick]
        pts += [a, (a + b) * np.float32(0.5)]
        s = rng.uniform(0, 1, (len(pick), 1)).astype(np.float32)
        pts.append(a + s * (b - a))
    pts = np.concatenate(pts)
    origins = np.concatenate([
        np.broadcast_to(np.float32(CAM), pts.shape),
        rng.uniform(-0.95, 0.95, pts.shape).astype(np.float32)])
    d = _unit(np.concatenate([pts, pts]) - origins)
    return torch.from_numpy(origins.copy()), torch.from_numpy(d)


def _axis_rays(seed=3, n=512):
    """Rays along +-x, +-y, +-z, and with one zero component, from random
    origins inside the scene."""
    rng = np.random.default_rng(seed)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    d = axes[rng.integers(0, 6, n)]
    two = rng.normal(size=(n, 3)).astype(np.float32)
    two[np.arange(n), rng.integers(0, 3, n)] = 0.0
    d = np.concatenate([d, _unit(two)])
    o = rng.uniform(-0.95, 0.95, d.shape).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))


def _grazing_rays(tris, seed=4, n_tri=128):
    """Rays from a point of a triangle's plane, outside it, along the
    plane towards the triangle's centroid, tilted off the plane by 1e-7 to
    1e-2 rad on either side."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = _corners(tris)
    pick = rng.choice(v0.shape[0], min(n_tri, v0.shape[0]), replace=False)
    a, b, c = (x[pick].astype(np.float64) for x in (v0, v1, v2))
    cen = (a + b + c) / 3
    n = np.cross(b - a, c - a)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    u = (a + b) / 2 - cen
    o = cen + 3.0 * u
    ang = 10.0 ** rng.uniform(-7, -2, (len(pick), 1)) * rng.choice(
        [-1, 1], (len(pick), 1))
    d = _unit(_unit(cen - o) + ang * n)
    return (torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d))


def _ray_set(kind, tris, mat):
    if kind == "camera":
        return _camera_rays()
    if kind == "bounce":
        return _bounce_rays(tris, mat)
    if kind == "edges":
        return _edge_rays(tris)
    if kind == "axis":
        return _axis_rays()
    return _grazing_rays(tris)


def _walk(b):
    """(leaves as (first, count), inner (parent box, child box) pairs) of
    a Bvh, from the root."""
    nodes = b.nodes.numpy()
    links = nodes[:, [3, 11]].copy().view(np.int32)
    leaves, nest, stack = [], [], [0]
    while stack:
        i = stack.pop()
        for side in (0, 1):
            link = int(links[i, side])
            lo, hi = nodes[i, 8 * side:8 * side + 3], \
                nodes[i, 8 * side + 4:8 * side + 7]
            if link == bv.EMPTY:
                continue
            if link >= 0:
                stack.append(link)
                for s2 in (0, 1):
                    if links[link, s2] != bv.EMPTY:
                        nest.append(((lo, hi), (
                            nodes[link, 8 * s2:8 * s2 + 3],
                            nodes[link, 8 * s2 + 4:8 * s2 + 7])))
            else:
                code = ~link
                leaves.append((code >> 3, code & 7, lo, hi))
    return leaves, nest


@pytest.mark.parametrize("name", SCENES)
def test_build_invariants(tables, name):
    """order is a permutation; every triangle sits in exactly one leaf of
    at most 4; leaf boxes hold their triangles' f32 corners and inner
    boxes their children's; the depth is within the kernel's stack;
    tris_sorted is tris[order] bit for bit; two builds are identical."""
    tris, _ = tables[name]
    b = bv.build_bvh(tris)
    t = tris.shape[0]
    order = b.order.numpy()
    assert b.order.dtype == torch.int32 and b.nodes.dtype == torch.float32
    assert b.nodes.shape[1] == 16 and b.nodes.shape[0] >= 1
    assert sorted(order.tolist()) == list(range(t))
    assert torch.equal(b.tris_sorted, tris[b.order.long()])
    leaves, nest = _walk(b)
    seen = np.zeros(t, np.int64)
    v0, v1, v2 = _corners(tris)
    for first, count, lo, hi in leaves:
        assert 1 <= count <= bv.LEAF_MAX
        for p in range(first, first + count):
            seen[order[p]] += 1
            for v in (v0, v1, v2):
                assert (lo <= v[order[p]]).all() and (v[order[p]] <= hi).all()
    assert (seen == 1).all()
    for (plo, phi), (clo, chi) in nest:
        assert (plo <= clo).all() and (chi <= phi).all()
    assert 1 <= b.depth <= bv.STACK
    again = bv.build_bvh(tris)
    assert torch.equal(again.nodes.view(torch.int32),
                       b.nodes.view(torch.int32))
    assert torch.equal(again.order, b.order) and again.depth == b.depth


@pytest.mark.parametrize("kind", ["camera", "bounce", "edges", "axis",
                                  "grazing"])
@pytest.mark.parametrize("name", ["cornell", "test_room", "torus", "soup"])
def test_walk_equals_sweep(tables, name, kind):
    """closest_hit_bvh_plain is closest_hit_plain bit for bit (t, index,
    material rows) and culls: fewer triangle tests than T a ray."""
    tris, mat = tables[name]
    o, d = _ray_set(kind, tris, mat)
    r = o.shape[0]
    ref = ip.closest_hit_plain(o, d, tris, r, mat)
    out = bv.closest_hit_bvh_plain(o, d, bv.build_bvh(tris), r, mat)
    for a, b in zip(ref, out[:3]):
        assert torch.equal(a, b)
    assert float((ref[0] < 1e38).float().mean()) > 0.05
    visits, tests = out[3:]
    assert (visits >= 1).all()
    assert float(tests.float().mean()) < tris.shape[0]


@pytest.mark.parametrize("name", ["empty", "one", "two_identical"])
def test_walk_tiny_tables(tables, name):
    """No triangle, one, and two identical ones (equal t: index 0 wins)."""
    tris, mat = tables[name]
    o, d = _camera_rays(16)
    ref = ip.closest_hit_plain(o, d, tris, o.shape[0], mat)
    out = bv.closest_hit_bvh_plain(o, d, bv.build_bvh(tris), o.shape[0],
                                   mat)
    for a, b in zip(ref, out[:3]):
        assert torch.equal(a, b)
    hits = ref[0] < 1e38
    assert bool(hits.any()) == (name != "empty")
    assert (out[1] == 0).all()


def test_duplicates_lower_index_wins(tables):
    """The Cornell box twice over (T = 76, each triangle and its copy in
    any leaves): every hit is an equal-t tie, and the lower index wins as
    in the sweep."""
    tris, mat = tables["cornell"]
    n = tris.shape[0]
    both = torch.cat([tris, tris]).contiguous()
    mat2 = torch.cat([mat, -mat]).contiguous()
    b = bv.build_bvh(both)
    for o, d in (_camera_rays(), _bounce_rays(tris, mat)):
        ref = ip.closest_hit_plain(o, d, both, o.shape[0], mat2)
        out = bv.closest_hit_bvh_plain(o, d, b, o.shape[0], mat2)
        for a, c in zip(ref, out[:3]):
            assert torch.equal(a, c)
        hit = ref[0] < 1e38
        assert float(hit.float().mean()) > 0.5
        assert bool((out[1][hit] < n).all())


@pytest.mark.parametrize("name", ["cornell", "torus"])
def test_active_count_half(tables, name):
    """Rays at index >= count are misses (INF, 0, zero row) with no
    visits; those below equal the sweep's."""
    tris, mat = tables[name]
    o, d = _camera_rays()
    half = o.shape[0] // 2
    ref = ip.closest_hit_plain(o, d, tris, half, mat)
    t, idx, rows, visits, tests = bv.closest_hit_bvh_plain(
        o, d, bv.build_bvh(tris), torch.tensor([half], dtype=torch.int32),
        mat)
    for a, b in zip(ref, (t, idx, rows)):
        assert torch.equal(a, b)
    assert (t[half:] == np.float32(3e38)).all() and (idx[half:] == 0).all()
    assert (rows[half:] == 0).all() and (visits[half:] == 0).all()
    assert (tests[half:] == 0).all() and (visits[:half] >= 1).all()


def test_walk_matches_jax_kernel(torus_preset):
    """The walk against the JAX Pallas kernel (closest_hit_packed,
    interpret mode) on the multi-tile generated scene, 1,600 camera rays
    and a bounce batch: the same triangle for every ray, and t within
    f32 rounding as tests/test_torch_intersect_pallas.py states it (1 ulp
    on >= 95% of hits, 1e-5 relative on all: JAX divides as tq * (1/det)
    and rounds the cancelling cross-product terms its own way)."""
    p = torus_preset
    js = jpresets.ScenePreset(
        name=p.name, obj=p.obj, camera_position=p.camera_position,
        default_rgb=p.default_rgb,
        material_rules=tuple(jobj.MaterialRule(r.lo, r.hi, r.rgb)
                             for r in p.material_rules),
        light_specs=tuple(jobj.LightSpec(s.I, s.J, s.K, s.L)
                          for s in p.light_specs),
        light_power=p.light_power, flip_winding=p.flip_winding).load()
    import jax
    o, d = primary_rays(jax.random.PRNGKey(0), JCamera.create(list(CAM)), 40,
                        40, 40.0)
    h = jax_closest_hit(o, d, js)
    o, d, t = np.asarray(o), np.asarray(d), np.asarray(h.t)
    hit = t < 1e38
    nd = _unit(np.random.default_rng(1).normal(size=d.shape))
    nd = np.where((nd * np.asarray(h.normal)).sum(1, keepdims=True) < 0, -nd,
                  nd)
    o2 = o + np.where(hit, t, 0.0)[:, None] * d + 1e-4 * nd
    o = np.concatenate([o, o2[hit]]).astype(np.float32)
    d = np.concatenate([d, nd[hit]]).astype(np.float32)
    r = o.shape[0]
    tj, ij = map(np.asarray, jip.closest_hit_packed(
        jnp.asarray(o), jnp.asarray(d), jip.pack_triangles(js), r,
        interpret=True))
    tris = ip.pack_triangles(p.load(device="cpu"))
    tt, it = bv.closest_hit_bvh_plain(torch.from_numpy(o), torch.from_numpy(d),
                                      bv.build_bvh(tris), r)[:2]
    tt, it = tt.numpy(), it.numpy()
    hj = tj < 1e38
    assert ((tt < 1e38) == hj).all() and hj.mean() > 0.5
    assert (it == ij).all()
    ulps = np.abs(tt.view(np.int32).astype(np.int64)
                  - tj.view(np.int32).astype(np.int64))[hj]
    assert (ulps <= 1).mean() >= 0.95
    np.testing.assert_allclose(tt[hj], tj[hj], rtol=1e-5)


def test_build_raises_beyond_stack(tables, monkeypatch):
    tris, _ = tables["torus"]
    depth = bv.build_bvh(tris).depth
    monkeypatch.setattr(bv, "STACK", depth - 1)
    with pytest.raises(ValueError, match="stack"):
        bv.build_bvh(tris)


def test_builds_counted_and_table_checked(tables):
    tris, _ = tables["cornell"]
    before = bv.BUILDS
    b = bv.build_bvh(tris)
    assert bv.BUILDS == before + 1
    with pytest.raises(ValueError):
        bv.build_bvh(tris[:, :8].contiguous())
    o, d = _camera_rays(8)
    with pytest.raises(ValueError, match="bvh"):
        ip.closest_hit_packed(o, d, tables["torus"][0], o.shape[0], bvh=b)
    # a table of the same size is refused too: the bvh keeps its own
    with pytest.raises(ValueError, match="bvh"):
        ip.closest_hit_packed(o, d, tris.clone(), o.shape[0], bvh=b)


@pytest.mark.parametrize("launcher", ["packed", "packed_mxu", "mat_mxu",
                                      "sweep"])
def test_launchers_take_bvh_on_cpu(tables, launcher):
    """On the CPU every launcher runs the brute-force twin whether or not
    it is given a bvh, and builds none itself; closest_hit_sweep (the
    card's brute-force reference) is the same twin there."""
    tris, mat = tables["torus"]
    o, d = _camera_rays(16)
    r = o.shape[0]
    ref = ip.closest_hit_plain(o, d, tris, r, mat)
    b = bv.build_bvh(tris)
    before = bv.BUILDS
    if launcher == "sweep":
        outs = [ip.closest_hit_sweep(o, d, tris, r, mat)]
    elif launcher == "mat_mxu":
        outs = [ip.closest_hit_mat_mxu(o, d, tris, mat, r, bvh=x)
                for x in (None, b)]
    else:
        fn = getattr(ip, f"closest_hit_{launcher}")
        outs = [fn(o, d, tris, r, bvh=x) for x in (None, b)]
    assert bv.BUILDS == before
    for out in outs:
        for a, c in zip(ref, out):
            assert torch.equal(a, c)


@pytest.mark.parametrize("loop", ["wavefront", "sarsa_fast", "lockstep_sarsa",
                                  "importance", "deep_wavefront"])
def test_loops_build_once_a_frame(loop):
    """Each loop that packs its tables once a frame builds one BVH there
    and hands it to every closest-hit call (on the CPU the launchers run
    the brute force, so a build per call would show here as more than
    one): one build a frame, however many iterations."""
    from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
    from rlrpt_tpu_torch.integrators import precompute
    from rlrpt_tpu_torch.integrators import sarsa_wavefront as sw
    from rlrpt_tpu_torch.integrators.reinforcement_tracer import (
        render_frame_sarsa)
    from rlrpt_tpu_torch.integrators.wavefront import render_wavefront
    from rlrpt_tpu_torch.radiance.grid_bucket import build_volume_class_table
    from rlrpt_tpu_torch.radiance.volumes import build_radiance_volumes

    scene = presets.load_scene("cornell", device="cpu")
    cam = Camera.create(CAM)
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=2,
                       max_ray_bounces=6)
    rl = RadianceVolumeConfig(area_per_sample=0.05)
    before = bv.BUILDS
    if loop == "wavefront":
        aux = render_wavefront(1, scene, cam, cfg, "cpu")[1]
        assert int(aux["wavefront_iterations"]) > 1
    elif loop == "deep_wavefront":
        from rlrpt_tpu_torch.config import DeepLearningConfig
        from rlrpt_tpu_torch.deep import deep_wavefront as dw
        from rlrpt_tpu_torch.nn.dq_network import DQNetwork
        net = DQNetwork(scene.vertices_flat.numel(),
                        rl.grid_resolution ** 2, (8, 8),
                        torch.Generator().manual_seed(0))
        dw.render_frame_pretrained_wavefront(1, scene, cam, net, cfg, rl,
                                             DeepLearningConfig(), pix_mux=2)
    else:
        vols = build_radiance_volumes(scene, rl)
        if loop == "sarsa_fast":
            sw.render_frame_sarsa_wavefront(
                1, scene, cam, vols, build_volume_class_table(vols, scene),
                cfg, rl)
        elif loop == "lockstep_sarsa":
            render_frame_sarsa(1, scene, cam, vols, cfg, rl)
        else:
            precompute.render_importance_sampled(
                torch.Generator().manual_seed(1), scene, cam, vols, cfg, rl)
    assert bv.BUILDS == before + 1
