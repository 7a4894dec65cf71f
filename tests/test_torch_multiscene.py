"""rlrpt_tpu_torch.parallel.multiscene against rlrpt_tpu.parallel.
multiscene on the CPU: padding keeps the render and the hits (B4a's twin
on its BVH included), the stacked arrays equal JAX's, and the batch render
and the joint training run in 2 spawned gloo ranks
(tests/_torch_dist_worker.py) with one net, bit-identical on both ranks.
The cornell + test_room pair stands in for JAX's cornell + box +
simple_room batch, whose OBJ models are absent."""

import jax
import numpy as np
import torch

from rlrpt_tpu import config as jconfig
from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.parallel import multiscene as jms
from rlrpt_tpu.parallel.mesh import make_mesh as j_make_mesh
from rlrpt_tpu.scene import presets as jpresets
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import (DeepLearningConfig, RadianceVolumeConfig,
                                    RenderConfig)
from rlrpt_tpu_torch.integrators.default_tracer import render_default
from rlrpt_tpu_torch.ops import intersect_pallas as ip
from rlrpt_tpu_torch.ops.bvh import build_bvh
from rlrpt_tpu_torch.parallel import multiscene as ms
from rlrpt_tpu_torch.parallel.multihost import spawn
from rlrpt_tpu_torch.scene import cornell_box
from _torch_dist_worker import run
from _torch_parity import one_torch_thread, torch_scene  # noqa: F401

A = np.asarray
KW = dict(width=20, height=20, samples_per_pixel=2, max_ray_bounces=3,
          ray_tile=512)
NAMES = ("cornell", "test_room")


def _jax_scenes():
    ps = [jpresets.get(n) for n in NAMES]
    return [p.load() for p in ps], [JCamera.create(p.camera_position)
                                    for p in ps]


def test_pad_scene_keeps_the_render_and_the_hits():
    scene = cornell_box(device="cpu")
    cam = Camera.create([0.0, 0.0, -3.0])
    padded = ms.pad_scene(scene, scene.n_surfaces + 7, 2 + 3)
    assert padded.n_triangles == scene.n_triangles + 10
    cfg = RenderConfig(**KW)
    img0, _ = render_default(0, scene, cam, cfg, "cpu")
    img1, _ = render_default(0, padded, cam, cfg, "cpu")
    np.testing.assert_allclose(img0.numpy(), img1.numpy(), rtol=1e-4,
                               atol=1e-5)
    # B4a's twin walks a BVH whose zero triangles all sit at the origin,
    # inside the box: the hits and material rows are the unpadded ones
    g = torch.Generator().manual_seed(3)
    n = 4096
    o = torch.rand((n, 3), generator=g) * 1.8 - 0.9
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g),
                                      dim=-1)
    o = torch.cat([o, torch.zeros((64, 3))])   # rays from the origin too
    d = torch.cat([d, d[:64]])
    hits = []
    for s in (scene, padded):
        tris, mat = ip.pack_scene_mxu(s)
        hits.append(ip.closest_hit_mat_mxu(o, d, tris, mat, o.shape[0],
                                           build_bvh(tris)))
    (t0, i0, m0), (t1, i1, m1) = hits
    assert torch.equal(t0, t1) and torch.equal(m0, m1)
    shift = torch.where(i0 >= scene.n_surfaces, 7, 0)
    hit = t0 < 1e38
    assert torch.equal(i1[hit], (i0 + shift)[hit])
    assert bool((i1[hit] < scene.n_surfaces).logical_or(
        i1[hit] >= scene.n_surfaces + 7).all())


def test_stacked_arrays_equal_jaxs():
    jscenes, _ = _jax_scenes()
    jb = jms.stack_scenes(jscenes)
    tb = ms.stack_scenes([torch_scene(s) for s in jscenes])
    assert tb.n_surfaces == jb.n_surfaces
    for f in ms._FIELDS:
        assert np.array_equal(getattr(tb, f).numpy(), A(getattr(jb, f))), f


def test_batch_render_matches_jax():
    jscenes, jcams = _jax_scenes()
    imgs_j = A(jms.render_multiscene_dp(jax.random.PRNGKey(0), jscenes,
                                        jcams, jconfig.RenderConfig(**KW),
                                        mesh=j_make_mesh(2)))
    outs = spawn(run, 2, ("multiscene_render",
                          {"seed": 0, "cfg": RenderConfig(**KW)}),
                 timeout=120)
    imgs = outs[0]["imgs"]
    assert np.array_equal(imgs, outs[1]["imgs"])
    assert imgs.shape == (2, 20, 20, 3) and np.isfinite(imgs).all()
    for k in range(2):   # the JAX test's bound for its batch render
        mj = float(imgs_j[k].mean())
        assert abs(float(imgs[k].mean()) - mj) < 0.5 * max(mj, 1e-3), k


def test_joint_training_shares_one_net():
    jscenes, _ = _jax_scenes()
    dl = dict(batch_size=256, hidden_sizes=(24, 32, 24))
    rl = RadianceVolumeConfig(grid_resolution=6)
    jparams, _, _ = jms.init_multiscene_neural_q(
        jax.random.PRNGKey(5), jscenes, jconfig.DeepLearningConfig(**dl),
        rl.grid_resolution)
    net, _, _ = ms.init_multiscene_neural_q(
        5, [torch_scene(s) for s in jscenes], DeepLearningConfig(**dl),
        rl.grid_resolution, device="cpu")
    assert [tuple(p.shape) for p in net.parameters()][::2] == [
        tuple(lp.w.shape) for lp in jparams.layers]
    outs = spawn(run, 2, ("multiscene_train",
                          {"seed": 6, "cfg": RenderConfig(**KW),
                           "dl": DeepLearningConfig(**dl), "epsilon": 0.05}),
                 timeout=120)
    for k in ("imgs", "loss", "eps", "count", "zclp"):
        assert np.array_equal(A(outs[0][k]), A(outs[1][k])), k
    for k in ("params", "mu", "nu"):
        for a, b in zip(outs[0][k], outs[1][k]):
            assert np.array_equal(a, b), k
    o = outs[0]
    assert o["imgs"].shape == (2, 20, 20, 3) and np.isfinite(o["imgs"]).all()
    assert np.isfinite(o["loss"]) and o["loss"] > 0.0
    assert o["count"] > 0
    assert any(not np.array_equal(a, b) for a, b in zip(o["p0"],
                                                          o["params"]))
    assert all(np.isfinite(p).all() for p in o["params"])
    assert o["zclp"].shape == (2,)
    assert abs(o["eps"] - 0.05) < 1e-6    # floored at epsilon_min
