"""rlrpt_tpu_torch checkpoints vs rlrpt_tpu's: one file format, read by
both packages; a full-state round trip; a resumed deep-Q run equal to an
uninterrupted one.  Also the profiling hooks and ``config.small``."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from rlrpt_tpu import config as jconfig
from rlrpt_tpu.deep.neural_q import init_neural_q as jax_init_neural_q
from rlrpt_tpu.radiance.volumes import build_radiance_volumes as jax_volumes
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu.utils import checkpoint as jckpt
from rlrpt_tpu_torch import config
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.deep.neural_q import init_neural_q, render_frame_neural_q
from rlrpt_tpu_torch.nn.adam import adam_update
from rlrpt_tpu_torch.radiance.volumes import build_radiance_volumes
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.utils import checkpoint, profiling
from _torch_parity import one_torch_thread  # noqa: F401

DL = config.DeepLearningConfig(hidden_sizes=(16, 16))
RL = config.RadianceVolumeConfig(area_per_sample=0.05, grid_resolution=6)
VOL_FIELDS = ("position", "normal", "frame", "surface_lum", "q", "visits",
              "cdf")


def _stepped_port_state(seed: int = 0):
    """A port network and an Adam state two steps in (moments non-zero),
    and fine-map volumes with a moved Q and visits."""
    net, opt = init_neural_q(seed, cornell_box(device="cpu"), DL,
                             RL.grid_resolution,
                             device="cpu")
    g = torch.Generator().manual_seed(seed)
    for _ in range(2):
        grads = [torch.randn(p.shape, generator=g) for p in net.parameters()]
        adam_update(list(net.parameters()), grads, opt, DL.learning_rate)
    vols = build_radiance_volumes(cornell_box(device="cpu"), RL)
    vols = dataclasses.replace(
        vols, q=vols.q * (1.0 + torch.rand(vols.q.shape, generator=g)),
        visits=torch.randint(0, 9, vols.visits.shape, generator=g,
                             dtype=torch.int32))
    return net, opt, vols


def _jax_state():
    params, opt = jax_init_neural_q(jax.random.PRNGKey(3), jax_cornell_box(),
                                    jconfig.DeepLearningConfig(
                                        hidden_sizes=(16, 16)), 6)
    tx = optax.adam(1e-3)
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.25), params)
    updates, opt = tx.update(grads, opt, params)
    params = optax.apply_updates(params, updates)
    vols = jax_volumes(jax_cornell_box(), jconfig.RadianceVolumeConfig(
        area_per_sample=0.05, grid_resolution=6))
    return params, opt, vols


def _assert_net_equal(net, jax_params):
    leaves = jax.tree_util.tree_leaves(jax_params)
    params = list(net.parameters())
    assert len(params) == len(leaves)
    for p, leaf in zip(params, leaves):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(leaf))


def _assert_opt_equal(opt, jax_opt):
    leaves = jax.tree_util.tree_leaves(jax_opt)
    ours = [opt.count, *opt.mu, *opt.nu]
    assert len(ours) == len(leaves) and opt.count.dtype == torch.int32
    for a, b in zip(ours, leaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_full_state_roundtrip(tmp_path):
    net, opt, vols = _stepped_port_state()
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_training_state(path, net, opt, epsilon=0.37, frame=12,
                                   vols=vols)
    net2, opt2, eps, frame, vols2 = checkpoint.load_training_state(
        path, device="cpu")
    assert eps == np.float32(0.37) and frame == 12
    for a, b in zip(net.parameters(), net2.parameters()):
        assert torch.equal(a, b)
    assert int(opt2.count) == 2 and opt2.count.dtype == torch.int32
    for a, b in zip(opt.mu + opt.nu, opt2.mu + opt2.nu):
        assert torch.equal(a, b)
    for f in VOL_FIELDS:
        assert torch.equal(getattr(vols, f), getattr(vols2, f)), f
    assert vols2.grid_resolution == vols.grid_resolution


def test_params_only_roundtrip(tmp_path):
    net, opt, _ = _stepped_port_state(1)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_training_state(path, net, opt, epsilon=0.05, frame=0)
    *_, vols = checkpoint.load_training_state(path, device="cpu")
    assert vols is None


def test_jax_checkpoint_loads_in_port(tmp_path):
    params, opt, vols = _jax_state()
    path = str(tmp_path / "jax.npz")
    jckpt.save_training_state(path, params, opt, epsilon=0.125, frame=7,
                              vols=vols)
    net, opt_t, eps, frame, vols_t = checkpoint.load_training_state(
        path, device="cpu")
    assert (eps, frame) == (0.125, 7)
    _assert_net_equal(net, params)
    _assert_opt_equal(opt_t, opt)
    for f in VOL_FIELDS:
        np.testing.assert_array_equal(getattr(vols_t, f).numpy(),
                                      np.asarray(getattr(vols, f)), f)


def test_port_checkpoint_loads_in_jax(tmp_path):
    net, opt, vols = _stepped_port_state(2)
    path = str(tmp_path / "port.npz")
    checkpoint.save_training_state(path, net, opt, epsilon=0.25, frame=3,
                                   vols=vols)
    ex_params, ex_opt, _ = _jax_state()
    params, opt_j, eps, frame, vols_j = jckpt.load_training_state(
        path, ex_params, ex_opt)
    assert (eps, frame) == (0.25, 3)
    _assert_net_equal(net, params)
    _assert_opt_equal(opt, opt_j)
    for f in VOL_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(vols_j, f)),
                                      getattr(vols, f).numpy(), f)
    assert vols_j.grid_resolution == vols.grid_resolution
    # the JAX update runs on the loaded state
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    optax.adam(1e-3).update(grads, opt_j, params)


def test_resumed_run_equals_uninterrupted(tmp_path):
    """Two lockstep neural-q frames in one go, and the same two with a
    checkpoint written and read back between them: equal weights, Adam
    state, epsilon and images, bit for bit (CPU)."""
    scene, cam = cornell_box(device="cpu"), Camera.create((0.0, 0.0, -3.0))
    cfg = config.RenderConfig(width=8, height=8, samples_per_pixel=1,
                              max_ray_bounces=4)
    dl = dataclasses.replace(DL, batch_size=32)

    def frame(i, net, opt, eps):
        return render_frame_neural_q(100 + i, scene, cam, net, opt, eps, cfg,
                                     RL, dl)

    net, opt = init_neural_q(4, scene, dl, RL.grid_resolution, device="cpu")
    eps = dl.epsilon_start
    imgs = []
    for i in range(2):
        img, net, opt, eps, _ = frame(i, net, opt, eps)
        imgs.append(img)

    net_r, opt_r = init_neural_q(4, scene, dl, RL.grid_resolution,
                                 device="cpu")
    img0, net_r, opt_r, eps_r, _ = frame(0, net_r, opt_r, dl.epsilon_start)
    path = str(tmp_path / "mid.npz")
    checkpoint.save_training_state(path, net_r, opt_r, eps_r, frame=1)
    net_r, opt_r, eps_r, start, _ = checkpoint.load_training_state(
        path, device="cpu")
    img1, net_r, opt_r, eps_r, _ = frame(start, net_r, opt_r, eps_r)
    assert torch.equal(img0, imgs[0]) and torch.equal(img1, imgs[1])
    assert eps_r == eps
    for a, b in zip(net.parameters(), net_r.parameters()):
        assert torch.equal(a, b)
    assert int(opt.count) == int(opt_r.count) > 0
    for a, b in zip(opt.mu + opt.nu, opt_r.mu + opt_r.nu):
        assert torch.equal(a, b)


def test_profiling_hooks(tmp_path):
    x = torch.ones(3)
    assert profiling.host_fence({"a": [x, (x, 2)], "b": None}) is None
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("hooks.sum"):
            torch.ones(64).sum()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any(e.get("name") == "hooks.sum"
               and e.get("cat") == "user_annotation"
               for e in trace["traceEvents"])


def test_small_config_matches_jax():
    ours, theirs = config.small(64, 48, 3, 5), jconfig.small(64, 48, 3, 5)
    for part in ("render", "rl", "deep", "trainer"):
        a, b = getattr(ours, part), getattr(theirs, part)
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), (part, f.name)
    assert config.Config() == config.Config()
