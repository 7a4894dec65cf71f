"""rlrpt_tpu_torch.parallel (the data-parallel layer on torch.distributed)
against the single-process port and against rlrpt_tpu.parallel.

The port's side runs in 2 spawned gloo ranks on the CPU
(tests/_torch_dist_worker.py), each spawn joined with a time limit; the
JAX side runs in this process on 2 devices of the 8-device CPU mesh, its
Pallas kernels in interpret mode.  The hooks are held exactly where the
math is the same: the SARSA update and the DQN gradient over two halves
equal the single-process call on the joined batch (visits exactly, Q and
the gradient within rtol 1e-5: only the order of the sums differs), and
the replicated state is bit-identical on both ranks.  The entry points
are held against JAX's 2-device run: the torch-loop paths statistically
(tests/test_parallel.py's bounds: mean within 0.35x, or within 3x the
seed-to-seed noise), the megakernel paths on JAX's per-device kernel
seeds at the bounds of tests/test_torch_guided_mega*.py.

On the card (``-m chip``) every dp and multiscene entry point runs in a
world of one over NCCL beside the single-process call it shards: bit for
bit where the world of one draws the same numbers (the megakernel frames,
the SARSA and deep wavefronts, the joint training), q within rtol 1e-4
where atomics add in another order, and statistically where the streams
differ (the default and lockstep tracers, the batch render).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlrpt_tpu import config as jconfig
from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.deep.neural_q import init_neural_q as j_init_nq
from rlrpt_tpu.parallel import dp as jdp
from rlrpt_tpu.parallel.mesh import make_mesh as j_make_mesh
from rlrpt_tpu.radiance.grid_bucket import build_volume_class_table as jtable
from rlrpt_tpu.radiance.volumes import build_radiance_volumes as jbuild
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
import torch.distributed as dist

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import (DeepLearningConfig, RadianceVolumeConfig,
                                    RenderConfig)
from rlrpt_tpu_torch.deep import deep_wavefront as dw
from rlrpt_tpu_torch.deep import neural_q as nq
from rlrpt_tpu_torch.deep.neural_q import train_on_batches
from rlrpt_tpu_torch.integrators.default_tracer import render_default
from rlrpt_tpu_torch.integrators.reinforcement_tracer import \
    render_frame_sarsa
from rlrpt_tpu_torch.integrators.sarsa_wavefront import \
    render_frame_sarsa_wavefront
from rlrpt_tpu_torch.nn.adam import adam_init
from rlrpt_tpu_torch.ops import guided_mega as gm
from rlrpt_tpu_torch.ops import guided_mega_train as gt
from rlrpt_tpu_torch.ops import megakernel as mk
from rlrpt_tpu_torch.parallel import dp, multihost, multiscene
from rlrpt_tpu_torch.parallel import mesh as pmesh
from rlrpt_tpu_torch.parallel.multihost import spawn
from rlrpt_tpu_torch.radiance.grid_bucket import build_volume_class_table
from rlrpt_tpu_torch.radiance.volumes import (build_radiance_volumes,
                                              expected_sarsa_update)
from rlrpt_tpu_torch.scene import cornell_box, presets
from rlrpt_tpu_torch.utils.convert import dq_network_from_numpy
from rlrpt_tpu_torch.utils.rng import fold_in
from _torch_dist_worker import run
from _torch_parity import (assert_frame_parity, card,  # noqa: F401
                           kernel_seed, one_torch_thread)

A = np.asarray
CAM = (0.0, 0.0, -3.0)
TIMEOUT = 120.0


def ranks(case: str, **payload) -> list:
    """The case's results on 2 gloo ranks."""
    return spawn(run, 2, (case, payload), timeout=TIMEOUT)


def same_on_both(outs, keys):
    for k in keys:
        a, b = outs[0][k], outs[1][k]
        for x, y in (zip(a, b) if isinstance(a, list) else [(a, b)]):
            assert np.array_equal(A(x), A(y)), k


def j_mesh():
    return j_make_mesh(2)


# ---- the mesh itself --------------------------------------------------------

def test_mesh_without_a_group_is_a_world_of_one():
    m = pmesh.make_mesh(device="cpu")
    assert (m.rank, m.size, m.group) == (0, 1, None)
    t = torch.arange(4.0)
    assert pmesh.psum(t, m) is t and pmesh.all_gather(t, m) is t
    assert pmesh.shard_range(10, m) == (0, 10)
    assert pmesh.pad_to_multiple(10, 4) == 12
    assert pmesh.rank_seed(7, 0) != pmesh.rank_seed(7, 1)
    assert pmesh.seed_of_rank([11], m) == 11
    with pytest.raises(ValueError, match="seeds for a world"):
        pmesh.seed_of_rank([1, 2], m)


# ---- the hooks --------------------------------------------------------------

def test_sarsa_update_over_two_halves_equals_the_joined_batch():
    rng = np.random.default_rng(0)
    rl = RadianceVolumeConfig(area_per_sample=0.05)
    vols = build_radiance_volumes(cornell_box(device="cpu"), rl)
    v, s = vols.n_volumes, vols.n_sectors
    q = (rng.random((v, s)) + 0.1).astype(np.float32)
    visits = rng.integers(0, 4, (v, s)).astype(np.int32)
    n = 4000
    batch = dict(vol_idx=rng.integers(0, 20, n),      # many collisions
                 sector=rng.integers(0, s, n),
                 target=rng.random(n).astype(np.float32),
                 mask=rng.random(n) < 0.8)
    outs = ranks("sarsa_update", q=q, visits=visits,
                 thr=rl.radiance_threshold, area_per_sample=0.05, **batch)
    same_on_both(outs, ("q", "visits"))
    ref = expected_sarsa_update(
        dataclasses.replace(vols, q=torch.from_numpy(q),
                            visits=torch.from_numpy(visits)),
        *(torch.from_numpy(batch[k]) for k in ("vol_idx", "sector",
                                               "target", "mask")),
        rl.radiance_threshold)
    assert np.array_equal(outs[0]["visits"], ref.visits.numpy())
    assert outs[0]["visits"].sum() - visits.sum() == batch["mask"].sum()
    np.testing.assert_allclose(outs[0]["q"], ref.q.numpy(), rtol=1e-5,
                               atol=0)


def _net_layers(seed=3, dims=(342, 24, 16, 36)):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 0.1, (o, i)).astype(np.float32),
             rng.normal(0, 0.1, o).astype(np.float32))
            for i, o in zip(dims[:-1], dims[1:])]


def test_dqn_gradient_and_adam_over_two_halves_equal_the_joined_batch():
    """Three global minibatches of 64: both ranks live; only rank 0 live
    (rank 1's half is all zero weight: both ranks still step); nobody
    live (no rank steps).  Two passes, so the second step reads the
    first's moments."""
    rng = np.random.default_rng(1)
    layers, b, n = _net_layers(), 64, 192
    batch = dict(prev_loc=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                 actions=rng.integers(0, 36, n),
                 tds=rng.uniform(0, 2, n).astype(np.float32),
                 weights=np.ones(n, np.float32))
    batch["weights"][b + b // 2:] = 0.0
    outs = ranks("train_batches", layers=layers, batch_size=b, steps=2,
                 **batch)
    same_on_both(outs, ("params", "mu", "nu", "count", "loss"))
    net = dq_network_from_numpy(layers)
    opt = adam_init(net.parameters())
    dl = DeepLearningConfig(batch_size=b)
    losses = [float(train_on_batches(
        net, opt, cornell_box(device="cpu"),
        *(torch.from_numpy(batch[k]) for k in ("prev_loc", "actions",
                                               "tds")), dl,
        weights=torch.from_numpy(batch["weights"]))) for _ in range(2)]
    assert outs[0]["count"] == int(opt.count) == 4
    np.testing.assert_allclose(outs[0]["loss"], losses, rtol=1e-5)
    # the first moments after the last step carry the summed gradients;
    # an entry that sums cancelling terms keeps the terms' rounding, so
    # the floor is 1e-6 of the tensor's largest entry
    for got, want in zip(outs[0]["mu"], opt.mu):
        want = want.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    for got, want in zip(outs[0]["params"], net.parameters()):
        np.testing.assert_allclose(got, want.detach().numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_wavefront_shards_with_unequal_work_complete():
    """The camera tipped up: one half of the frame looks out of the box
    and its samples end at once.  The two shards run different numbers of
    live iterations, yet both ranks finish the frame together with one
    Q table, for the SARSA and the training deep wavefront."""
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=4,
                       max_ray_bounces=8)
    outs = ranks("uneven_sarsa", cfg=cfg, yaw_x=0.4, pix_mux=1)
    assert outs[0]["iters"] != outs[1]["iters"], [o["iters"] for o in outs]
    same_on_both(outs, ("q", "visits", "td"))
    assert outs[0]["visits"].sum() == outs[0]["td"] > 0
    assert all(np.isfinite(o["img"]).all() for o in outs)
    dl = DeepLearningConfig(batch_size=32, hidden_sizes=(16, 16))
    outs = ranks("uneven_deep", cfg=cfg, yaw_x=0.4,
                 layers=_net_layers(4, (342, 16, 16, 36)), dl=dl)
    assert outs[0]["iters"] != outs[1]["iters"], [o["iters"] for o in outs]
    same_on_both(outs, ("params", "mu", "nu", "count"))
    assert outs[0]["count"] > 0


# ---- the dp entry points against JAX's 2-device run -------------------------

def _means_close(port_img, jax_img, share=0.35):
    mt, mj = float(A(port_img).mean()), float(A(jax_img).mean())
    assert np.isfinite(A(port_img)).all()
    assert abs(mt - mj) < share * max(mj, 1e-3), (mt, mj)


def _within_noise(port_img, jax_a, jax_b):
    noise = float(np.mean(np.abs(A(jax_a) - A(jax_b))))
    err = float(np.mean(np.abs(A(port_img) - A(jax_a))))
    assert err < 3.0 * noise + 1e-3, (err, noise)


def test_render_default_dp_matches_jax():
    kw = dict(width=24, height=24, samples_per_pixel=16, max_ray_bounces=4,
              ray_tile=1024)
    img_j, _ = jdp.render_default_dp(jax.random.PRNGKey(0), jax_cornell_box(),
                                     JCamera.create(CAM),
                                     jconfig.RenderConfig(**kw), mesh=j_mesh())
    outs = ranks("default", seed=0, cfg=RenderConfig(**kw))
    same_on_both(outs, ("img", "avg_path"))
    assert outs[0]["img"].shape == (24, 24, 3)
    assert outs[0]["avg_path"] > 0
    _means_close(outs[0]["img"], img_j)


def test_render_frame_sarsa_dp_matches_jax():
    kw = dict(width=24, height=24, samples_per_pixel=2, max_ray_bounces=4,
              ray_tile=1024)
    rl = jconfig.RadianceVolumeConfig(area_per_sample=0.05)
    img_j, _, _ = jdp.render_frame_sarsa_dp(
        jax.random.PRNGKey(0), jax_cornell_box(), JCamera.create(CAM),
        jbuild(jax_cornell_box(), rl), jconfig.RenderConfig(**kw), rl,
        mesh=j_mesh())
    outs = ranks("sarsa_lockstep", seed=0, cfg=RenderConfig(**kw),
                 area_per_sample=0.05)
    same_on_both(outs, ("img", "q", "visits", "cdf", "td"))
    o = outs[0]
    assert o["visits"].sum() == o["td"] > 0    # the visit invariant
    assert not np.allclose(o["q"], o["q0"])
    assert np.isfinite(o["q"]).all()
    _means_close(o["img"], img_j)


def test_render_frame_sarsa_wavefront_dp_matches_jax():
    kw = dict(width=24, height=24, samples_per_pixel=8, max_ray_bounces=8,
              ray_tile=1024)
    js, rl = jax_cornell_box(), jconfig.RadianceVolumeConfig(
        area_per_sample=0.05)
    jv = jbuild(js, rl)
    imgs_j = [jdp.render_frame_sarsa_wavefront_dp(
        jax.random.PRNGKey(k), js, JCamera.create(CAM), jv, jtable(jv, js),
        jconfig.RenderConfig(**kw), rl, mesh=j_mesh(), interpret=True)[0]
        for k in (0, 1)]
    outs = ranks("sarsa_wavefront", seed=0, cfg=RenderConfig(**kw),
                 area_per_sample=0.05)
    same_on_both(outs, ("img", "q", "visits", "td"))
    assert outs[0]["visits"].sum() == outs[0]["td"] > 0
    _within_noise(outs[0]["img"], *imgs_j)


DEEP_KW = dict(width=24, height=24, samples_per_pixel=4, max_ray_bounces=8,
               ray_tile=1024)
DEEP_DL = dict(batch_size=256, hidden_sizes=(32, 48, 32))


@pytest.fixture(scope="module")
def jax_net():
    return j_init_nq(jax.random.PRNGKey(7), jax_cornell_box(),
                     jconfig.DeepLearningConfig(**DEEP_DL), 6)


def _layers(params):
    return [(A(lp.w), A(lp.b)) for lp in params.layers]


def _moved_and_finite(out, layers):
    assert any(not np.array_equal(p, w) for p, (w, _) in
               zip(out["params"][::2], layers))
    assert all(np.isfinite(p).all() for p in out["params"])


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["b4a", "plain_hit"])
def test_neural_q_train_step_dp_matches_jax(jax_net, use_pallas):
    kw = dict(width=24, height=24, samples_per_pixel=2, max_ray_bounces=4,
              ray_tile=1024)
    dl = dict(batch_size=512, hidden_sizes=(32, 48, 32))
    params, opt = jax_net
    rl = jconfig.RadianceVolumeConfig(grid_resolution=6)
    tp_j, _, _, loss_j = jdp.neural_q_train_step_dp(
        jax.random.PRNGKey(1), jax_cornell_box(), JCamera.create(CAM),
        params, opt, 0.3, jconfig.RenderConfig(**kw), rl,
        jconfig.DeepLearningConfig(**dl), mesh=j_mesh(),
        use_pallas=use_pallas, interpret=True)
    outs = ranks("nq_step", seed=1, cfg=RenderConfig(**kw),
                 layers=_layers(params), dl=DeepLearningConfig(**dl),
                 epsilon=0.3, use_pallas=use_pallas)
    same_on_both(outs, ("tp", "params", "mu", "nu", "count", "loss"))
    o = outs[0]
    assert o["tp"].shape == (24 * 24, 3) and np.isfinite(o["tp"]).all()
    assert o["loss"] > 0.0 and float(loss_j) > 0.0
    _moved_and_finite(o, _layers(params))
    _means_close(o["tp"], tp_j)


def test_deep_wavefront_dps_match_jax(jax_net):
    params, opt = jax_net
    cfg_j = jconfig.RenderConfig(**DEEP_KW)
    rl = jconfig.RadianceVolumeConfig(grid_resolution=6)
    dl_j = jconfig.DeepLearningConfig(**DEEP_DL)
    imgs_j = [jdp.render_frame_pretrained_wavefront_dp(
        jax.random.PRNGKey(k), jax_cornell_box(), JCamera.create(CAM),
        params, cfg_j, rl, dl_j, mesh=j_mesh(), interpret=True)[0]
        for k in (3, 4)]
    outs = ranks("pretrained", seed=3, cfg=RenderConfig(**DEEP_KW),
                 layers=_layers(params), dl=DeepLearningConfig(**DEEP_DL))
    same_on_both(outs, ("img", "avg_path"))
    _within_noise(outs[0]["img"], *imgs_j)

    img_j, _, _, eps_j, aux_j = jdp.render_frame_neural_q_wavefront_dp(
        jax.random.PRNGKey(5), jax_cornell_box(), JCamera.create(CAM),
        params, opt, 1.0, cfg_j, rl, dl_j, mesh=j_mesh(), interpret=True)
    outs = ranks("nq_wavefront", seed=5, cfg=RenderConfig(**DEEP_KW),
                 layers=_layers(params), dl=DeepLearningConfig(**DEEP_DL),
                 epsilon=1.0)
    same_on_both(outs, ("img", "params", "mu", "nu", "count", "loss", "eps"))
    o = outs[0]
    assert o["eps"] == float(eps_j)
    assert np.isfinite(o["loss"]) and np.isfinite(float(aux_j["loss"]))
    _moved_and_finite(o, _layers(params))
    _means_close(o["img"], img_j)


# ---- the megakernel entry points on JAX's per-device kernel seeds -----------

G, T_PAD = 11, 40           # sector grid; cornell's 38 triangles padded


def _device_seeds(key, n=2):
    """The int seeds JAX's 2-device run hands its kernels: device i keys
    with fold_in(key, i), and the launcher draws the seed from that."""
    return [kernel_seed(jax.random.fold_in(key, i)) for i in range(n)]


def _jax_table(uv_bins, skew):
    from rlrpt_tpu.ops import guided_mega_train as jgt
    rng = np.random.default_rng(2)
    q0, _ = jgt.init_bin_q(T_PAD, uv_bins, G, 0.5)
    q = np.array(q0) * np.exp(skew * rng.random(np.shape(q0)))
    return jgt.rebuild_bin_cdf(jnp.asarray(q, jnp.float32), G, uv_bins,
                               T_PAD)


def test_render_guided_mega_dp_matches_jax():
    kw = dict(width=32, height=32, samples_per_pixel=4, max_ray_bounces=10)
    key = jax.random.PRNGKey(1)
    tj = _jax_table(4, 3.0)
    img_j, aux_j = jdp.render_guided_mega_dp(
        key, jax_cornell_box(), JCamera.create(CAM), tj,
        jconfig.RenderConfig(**kw), mesh=j_mesh(), r_tile=128, pix_mux=1,
        interpret=True, precision="highest")
    outs = ranks("guided", seeds=_device_seeds(key), cfg=RenderConfig(**kw),
                 cdf=A(tj.cdf, np.float32), sector_grid=G, uv_bins=4,
                 t_pad=T_PAD, r_tile=128, pix_mux=1)
    same_on_both(outs, ("img", "avg_path"))
    assert_frame_parity(outs[0]["img"], {"avg_path_length":
                                         outs[0]["avg_path"]},
                        img_j, aux_j)


def test_sarsa_mega_train_dp_matches_jax(monkeypatch):
    """The merged learning frame on both sides: the image as the guided
    frame's; the visits equal on >= 99% of the entries with the visit mass
    within 1.5%; q within rtol 1e-3 on >= 98% (tests/test_torch_guided_
    mega_train.py's bounds: a flipped near-tie moves a transition to
    another bin); the visit invariant exact on each side.  JAX's
    sarsa_mega_train_dp takes no precision argument, so its launcher is
    given "highest" here, as the single-process parity tests run it (at
    its default "high3" about 4% of the pixels flip a hit)."""
    import functools

    from rlrpt_tpu.ops import guided_mega_train as jgt
    monkeypatch.setattr(jgt, "render_sarsa_mega_train", functools.partial(
        jgt.render_sarsa_mega_train, precision="highest"))
    kw = dict(width=32, height=32, samples_per_pixel=4, max_ray_bounces=6)
    key = jax.random.PRNGKey(10)
    rl = jconfig.RadianceVolumeConfig(grid_resolution=G)
    qj, vj = jgt.init_bin_q(T_PAD, 4, G, rl.initial_radiance)
    tj = jgt.rebuild_bin_cdf(qj, G, 4, T_PAD)
    img_j, q_j, v_j, aux_j = jdp.sarsa_mega_train_dp(
        key, jax_cornell_box(), JCamera.create(CAM), tj, qj, vj,
        jconfig.RenderConfig(**kw), rl.radiance_threshold, mesh=j_mesh(),
        r_tile=512, pix_mux=2, interpret=True)
    outs = ranks("sarsa_mega", seeds=_device_seeds(key),
                 cfg=RenderConfig(**kw), cdf=A(tj.cdf, np.float32),
                 q=A(qj, np.float32), visits=A(vj, np.float32),
                 thr=rl.radiance_threshold, sector_grid=G, uv_bins=4,
                 t_pad=T_PAD, r_tile=512, pix_mux=2)
    same_on_both(outs, ("img", "q", "visits", "td"))
    o = outs[0]
    assert o["visits"].sum() - A(vj).sum() == o["td"] > 0
    assert float(A(v_j - vj).sum()) == int(aux_j["td_scatter_count"])
    img_t = o["img"]
    close = np.isclose(img_t, A(img_j), atol=1e-4, rtol=1e-3).all(axis=-1)
    assert np.isfinite(img_t).all() and close.mean() >= 0.99, close.mean()
    mt, mj = float(img_t.mean()), float(A(img_j).mean())
    assert abs(mt - mj) <= 0.005 * mj, (mt, mj)
    va, vb = A(v_j), o["visits"]
    assert (va == vb).mean() >= 0.99, (va == vb).mean()
    assert np.abs(va - vb).sum() <= 0.015 * va.sum()
    qa, qb = A(q_j)[:G * G], o["q"][:G * G]
    for rtol, share in ((1e-3, 0.98), (1e-1, 0.99)):
        frac = np.isclose(qb, qa, rtol=rtol, atol=0.0).mean()
        assert frac >= share, (rtol, frac)


def test_megakernel_dps_refuse_an_spp_the_world_does_not_divide():
    from rlrpt_tpu.ops import guided_mega_train as jgt
    kw = dict(width=8, height=8, samples_per_pixel=3, max_ray_bounces=2)
    q, _ = jgt.init_bin_q(T_PAD, 4, G, 0.5)
    tj = jgt.rebuild_bin_cdf(q, G, 4, T_PAD)
    with pytest.raises(ValueError, match="must divide"):
        jdp.render_guided_mega_dp(jax.random.PRNGKey(0), jax_cornell_box(),
                                  JCamera.create(CAM), tj,
                                  jconfig.RenderConfig(**kw), mesh=j_mesh())
    outs = ranks("spp_check", cfg=RenderConfig(**kw),
                 cdf=A(tj.cdf, np.float32), sector_grid=G, uv_bins=4,
                 t_pad=T_PAD)
    for msgs in outs:
        assert msgs == ["spp 3 must divide the mesh size 2"] * 2, msgs


# ---- the entry points in a world of one over NCCL, on the card ---------------

@pytest.fixture(scope="module")
def nccl(card):
    """A world of one over NCCL (its ranks meet on the loopback), torn
    down after the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NCCL_SOCKET_IFNAME", "lo")
        multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                             device=card)
        try:
            mesh = pmesh.make_mesh(device=card)
            assert (mesh.backend, mesh.size) == ("nccl", 1)
            yield mesh
        finally:
            dist.destroy_process_group()


def _z(a, b) -> float:
    """The difference of two frames' means over its standard error, from
    the per-pixel differences (two independent frames)."""
    a, b = a.double().reshape(-1, 3).mean(-1), b.double().reshape(
        -1, 3).mean(-1)
    return float((a.mean() - b.mean()) / ((a - b).var() / a.numel()).sqrt())


def _same(xs, ys) -> None:
    for x, y in zip(xs, ys, strict=True):
        assert torch.equal(x, y)


@pytest.mark.chip
def test_render_default_dp_on_the_card(nccl):
    """The plain default tracer sharded: its mean within 4 standard errors
    of B1's at 32 spp (other random streams)."""
    scene, camera = cornell_box(device=nccl.device), Camera.create(CAM)
    kw = dict(width=256, height=256, max_ray_bounces=80)
    img, _ = dp.render_default_dp(1984, scene, camera, RenderConfig(
        samples_per_pixel=8, ray_tile=256 * 256, **kw), nccl)
    ref, _ = mk.render_default_mega(1985, scene, camera, RenderConfig(
        samples_per_pixel=32, **kw), nccl.device)
    assert torch.isfinite(img).all()
    assert abs(_z(img, ref)) < 4.0


@pytest.mark.chip
def test_binned_dps_are_the_launchers_on_the_card(nccl):
    """Three sarsa_mega_train_dp frames (B2), then render_guided_mega_dp
    (B3): each frame's image and visits are the launcher's at the rank-0
    seed, its q within rtol 1e-4 (B2's atomics), the visit invariant
    exact; the guided frame the launcher's."""
    dev = nccl.device
    scene, camera = cornell_box(device=dev), Camera.create(CAM)
    rl = RadianceVolumeConfig(grid_resolution=11)
    cfg = RenderConfig(width=256, height=256, samples_per_pixel=32,
                       max_ray_bounces=80)
    q, v = gt.init_bin_q(40, 4, 11, rl.initial_radiance, device=dev)
    for f in range(3):
        table = gt.rebuild_bin_cdf(q, 11, 4, 40)
        img, q_dp, v_dp, aux = dp.sarsa_mega_train_dp(
            fold_in(1984, f), scene, camera, table, q, v, cfg,
            rl.radiance_threshold, nccl)
        img1, q1, v1, _ = gt.render_sarsa_mega_train(
            pmesh.rank_seed(fold_in(1984, f), 0), scene, camera, table, q, v,
            cfg, rl.radiance_threshold, dev)
        _same((img, v_dp), (img1, v1))
        assert float((v_dp - v).double().sum()) == int(
            aux["td_scatter_count"]) > 0
        torch.testing.assert_close(q_dp, q1, rtol=1e-4, atol=0.0)
        q, v = q_dp, v_dp
    table = gt.rebuild_bin_cdf(q, 11, 4, 40)
    img, _ = dp.render_guided_mega_dp(1987, scene, camera, table, cfg, nccl)
    img1, _ = gm.render_guided_mega(pmesh.rank_seed(1987, 0), scene, camera,
                                    table, cfg, dev)
    assert torch.equal(img, img1)


@pytest.mark.chip
def test_fine_map_dps_on_the_card(nccl):
    """render_frame_sarsa_wavefront_dp (B4a) is the single-process frame
    at the rank-0 seed: image and visits bit for bit, q within rtol 1e-4
    (index_add_ on the card adds in any order); render_frame_sarsa_dp
    (lockstep, B4b) draws other streams: its mean within 4 standard
    errors of the single-process frame's.  Both keep the visit
    invariant."""
    dev = nccl.device
    scene, camera = cornell_box(device=dev), Camera.create(CAM)
    rl = RadianceVolumeConfig(area_per_sample=0.01)
    vols = build_radiance_volumes(scene, rl)
    table = build_volume_class_table(vols, scene)
    cfg = RenderConfig(width=128, height=128, samples_per_pixel=8,
                       max_ray_bounces=80)
    img, vols_dp, aux = dp.render_frame_sarsa_wavefront_dp(
        1985, scene, camera, vols, table, cfg, rl, nccl)
    img1, vols1, _ = render_frame_sarsa_wavefront(
        pmesh.rank_seed(1985, 0), scene, camera, vols, table, cfg, rl,
        pix_mux=4)
    _same((img, vols_dp.visits), (img1, vols1.visits))
    torch.testing.assert_close(vols_dp.q, vols1.q, rtol=1e-4, atol=1e-6)
    assert int((vols_dp.visits - vols.visits).sum()) == int(
        aux["td_scatter_count"]) > 0
    cfg = dataclasses.replace(cfg, samples_per_pixel=4)
    img, vols_dp, aux = dp.render_frame_sarsa_dp(1992, scene, camera, vols,
                                                 cfg, rl, nccl)
    img1, _, _ = render_frame_sarsa(pmesh.rank_seed(1992, 0), scene, camera,
                                    vols, cfg, rl)
    assert int((vols_dp.visits - vols.visits).sum()) == int(
        aux["td_scatter_count"]) > 0
    assert abs(_z(img, img1)) < 4.0


@pytest.mark.chip
def test_deep_dps_on_the_card(nccl):
    """The pretrained and the training wavefront dp frames (B4a) are the
    single-process frames at the rank-0 seed, the trained net, its Adam
    moments and epsilon too; the lockstep neural_q_train_step_dp's mean
    within 4 standard errors of a single-process frame's."""
    dev = nccl.device
    scene, camera = cornell_box(device=dev), Camera.create(CAM)
    dl, rl = DeepLearningConfig(), RadianceVolumeConfig()
    cfg = RenderConfig(width=128, height=128, samples_per_pixel=4,
                       max_ray_bounces=80)
    net, _ = nq.init_neural_q(7, scene, dl, 12, device=dev)
    img, _ = dp.render_frame_pretrained_wavefront_dp(
        1986, scene, camera, net, cfg, rl, dl, nccl)
    img1, _ = dw.render_frame_pretrained_wavefront(
        pmesh.rank_seed(1986, 0), scene, camera, net, cfg, rl, dl, pix_mux=4)
    assert torch.equal(img, img1)
    cfg = dataclasses.replace(cfg, samples_per_pixel=1)
    (net_a, opt_a), (net_b, opt_b) = (nq.init_neural_q(8, scene, dl, 12,
                                                       device=dev)
                                      for _ in range(2))
    img, _, _, eps, _ = dp.render_frame_neural_q_wavefront_dp(
        1987, scene, camera, net_a, opt_a, dl.epsilon_start, cfg, rl, dl,
        nccl, pix_mux=8)
    img1, _, _, eps1, _ = dw.render_frame_neural_q_wavefront(
        pmesh.rank_seed(1987, 0), scene, camera, net_b, opt_b,
        dl.epsilon_start, cfg, rl, dl, pix_mux=8)
    assert eps == eps1 == nq.decay_epsilon(dl.epsilon_start, 1, dl)
    _same((img, *net_a.parameters(), *opt_a.mu, *opt_a.nu),
          (img1, *net_b.parameters(), *opt_b.mu, *opt_b.nu))
    (net_a, opt_a), (net_b, opt_b) = (nq.init_neural_q(9, scene, dl, 12,
                                                       device=dev)
                                      for _ in range(2))
    tp, *_, loss = dp.neural_q_train_step_dp(1988, scene, camera, net_a,
                                             opt_a, 0.3, cfg, rl, dl, nccl)
    img1, *_ = nq.render_frame_neural_q(pmesh.rank_seed(1988, 0), scene,
                                        camera, net_b, opt_b, 0.3, cfg, rl,
                                        dl)
    assert torch.isfinite(tp).all() and np.isfinite(float(loss))
    assert abs(_z(tp, img1)) < 4.0


@pytest.mark.chip
def test_multiscene_dps_on_the_card(nccl):
    """The batch render of Cornell and the test room: each image's mean
    within 4 standard errors of the single-process default render's (other
    random streams); the joint training
    frame (both scenes on the one rank, one after the other) is two
    single-process training frames on the padded scenes, net and Adam
    state too."""
    dev = nccl.device
    room = presets.get("test_room")
    scenes = [cornell_box(device=dev), room.load(device=dev)]
    cams = [Camera.create(CAM), Camera.create(room.camera_position)]
    cfg = RenderConfig(width=256, height=256, samples_per_pixel=8,
                       max_ray_bounces=80, ray_tile=256 * 256)
    imgs = multiscene.render_multiscene_dp(1989, scenes, cams, cfg, nccl)
    for k, (sc, cam) in enumerate(zip(scenes, cams)):
        ref, _ = render_default(1990 + k, sc, cam, cfg, dev)
        assert abs(_z(imgs[k], ref)) < 4.0
    dl, rl = DeepLearningConfig(), RadianceVolumeConfig()
    cfg = RenderConfig(width=128, height=128, samples_per_pixel=1,
                       max_ray_bounces=80)
    (net_a, opt_a, batched), (net_b, opt_b, _) = (
        multiscene.init_multiscene_neural_q(10, scenes, dl, 12, device=dev)
        for _ in range(2))
    imgs, _, _, eps, _ = multiscene.train_multiscene_deep_dp(
        1991, scenes, cams, net_a, opt_a, 0.05, cfg, rl, dl, nccl,
        batched=batched)
    ref = [dw.render_frame_neural_q_wavefront(
        pmesh.rank_seed(1991, 0), multiscene.scene_at(batched, k), cam,
        net_b, opt_b, 0.05, cfg, rl, dl, pix_mux=2)[0]
        for k, cam in enumerate(cams)]
    assert abs(eps - 0.05) < 1e-6
    _same((*imgs, *net_a.parameters(), *opt_a.mu),
          (*ref, *net_b.parameters(), *opt_b.mu))
