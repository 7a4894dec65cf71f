"""rlrpt_tpu_torch's deep-Q tracers against rlrpt_tpu's on the CPU: the
direction sampler on JAX's own uniforms, the TD targets, one trace step,
the respawn, the lockstep and wavefront frames (pretrained and neural-q,
minibatch and fused, f32 and bf16), the epsilon schedule and the four
CLI modes.

The JAX frames run their Pallas hit kernel in interpret mode and draw
from threefry, the port's from a torch.Generator through kernel B4a's
exact-f32 twin, so a port frame is held to the spread of JAX frames of
FRAME_SEEDS other seeds (_torch_parity.hold_to_jax): its mean, its 3x3
block means, and its mean absolute distance from JAX's average frame.  Sizes are the
JAX tests': 24x24, 8 bounces, a 6x6 sector grid, a 32-48-32 net,
256-ray minibatches; the frames take 8 spp and an environment light of
0.5 (so escaping paths add their throughput), where one frame's mean
spreads by 4-5% from seed to seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.config import DeepLearningConfig as JDL
from rlrpt_tpu.config import RadianceVolumeConfig as JRL
from rlrpt_tpu.config import RenderConfig as JCfg
from rlrpt_tpu.deep import deep_wavefront as jdw
from rlrpt_tpu.deep import neural_q as jnq
from rlrpt_tpu.deep.pretrained import render_frame_pretrained as j_pretrained
from rlrpt_tpu.nn.dq_network import dq_init
from rlrpt_tpu.nn.dynet_io import save_dynet_model as j_save_model
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu.scene.scene import save_vertices_to_file as j_save_vertices
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import (DeepLearningConfig, RadianceVolumeConfig,
                                    RenderConfig)
from rlrpt_tpu_torch.deep import deep_wavefront as dw
from rlrpt_tpu_torch.deep import neural_q as nq
from rlrpt_tpu_torch.deep.pretrained import render_frame_pretrained
from rlrpt_tpu_torch.nn.adam import adam_init
from rlrpt_tpu_torch.ops import intersect_pallas as ip
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.tools import render
from rlrpt_tpu_torch.utils.convert import dq_network_from_numpy
from rlrpt_tpu_torch.utils.image import read_png
from _torch_parity import hold_to_jax, one_torch_thread  # noqa: F401

A = np.asarray
KW = dict(width=24, height=24, samples_per_pixel=4, max_ray_bounces=8,
          ray_tile=1024)
GR = 6
DL = dict(batch_size=256, hidden_sizes=(32, 48, 32))
CAM = (0.0, 0.0, -3.0)


@pytest.fixture(scope="module")
def jax_net():
    """JAX's initial net and optax state (seed 7), as the JAX tests make
    them."""
    return jnq.init_neural_q(jax.random.PRNGKey(7), jax_cornell_box(),
                             JDL(**DL), GR)


def _net(jax_params):
    return dq_network_from_numpy([(A(lp.w), A(lp.b))
                                  for lp in jax_params.layers])


def _random_q(rng, n, s):
    qs = rng.uniform(0, 2, (n, s)).astype(np.float32)
    qs[rng.random((n, s)) < 0.3] = 0.0      # the output ReLU's zeros
    qs[:8] = 0.0                            # all-zero rows: uniform fallback
    return qs


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_sample_directions_on_jax_uniforms():
    """The port's sampler fed JAX's own draws (the key splits of
    neural_q.sample_directions): the same sector for >= 99.9% of rays (a
    draw on a CDF boundary may fall the other way, since torch.cumsum and
    XLA's sum in another order), pdf factor and direction allclose on
    those (JAX's sampler jitted, as its frames run it); all-zero Q rows
    sample uniformly (pdf RHO)."""
    rng = np.random.default_rng(0)
    n, s = 4096, GR * GR
    qs, normal = _random_q(rng, n, s), _unit(rng, n)
    key = jax.random.PRNGKey(1)
    state = jnq.NeuralQState(*([None] * 2), jnp.asarray(normal),
                             *([None] * 7))
    j_d, j_sec, j_fac = jax.jit(jnq.sample_directions, static_argnums=(
        4, 5))(key, jnp.asarray(qs), state, 0.3, GR, 1.0 / s)
    k_eps, k_r, k_rand, k_jit = jax.random.split(key, 4)
    u = np.concatenate([
        A(jax.random.uniform(k_eps, (n,)))[:, None],
        A(jax.random.uniform(k_r, (n, 1))),
        A(jax.random.uniform(k_rand, (n,)))[:, None],
        A(jax.random.uniform(k_jit, (n, 2)))], axis=1)
    d, sec, pdf = nq.sample_q_directions_u(
        torch.from_numpy(u), torch.from_numpy(qs), torch.from_numpy(normal),
        0.3, GR, 1.0 / s)
    fac = (torch.from_numpy(normal) * d).sum(-1) / torch.clamp(pdf, min=1e-12)
    same = sec.numpy() == A(j_sec)
    assert same.mean() >= 0.999, same.mean()
    # jit's fused sin/cos move a direction by ~1e-6; the factor divides it
    # by pdfs down to ~0.2
    np.testing.assert_allclose(d.numpy()[same], A(j_d)[same], atol=1e-5)
    np.testing.assert_allclose(fac.numpy()[same], A(j_fac)[same], rtol=1e-5,
                               atol=5e-5)
    explore = u[:, 0] <= 0.3
    assert 0.25 < explore.mean() < 0.35
    assert torch.allclose(pdf[:8], torch.full((8,), nq.RHO))
    g = torch.Generator().manual_seed(2)
    st = nq.NeuralQState(*([None] * 2), torch.from_numpy(normal),
                         *([None] * 7))
    d2, sec2, fac2 = nq.sample_directions(g, torch.from_numpy(qs), st, 0.0,
                                          GR, 1.0 / s)
    assert torch.isfinite(fac2).all() and (fac2 >= 0).all()
    assert ((d2 * st.normal).sum(-1) >= -1e-6).all()


def _td_state(rng, n):
    states = rng.integers(0, 3, n).astype(np.int32)
    rewards = rng.uniform(0, 3, n).astype(np.float32)
    discounts = rng.uniform(0, 1, n).astype(np.float32)
    return states, rewards, discounts


def test_td_targets_exact_with_the_scan_seed_quirk(monkeypatch, jax_net):
    """compute_td_targets on the same Q rows (both forwards stubbed to
    return them) equals JAX's exactly: Q_0 enters the max unweighted by
    cos, so a row whose only large value is Q_0 bootstraps Q_0 itself.
    With the real forwards it is within rtol 1e-5."""
    rng = np.random.default_rng(3)
    n, s = 512, GR * GR
    qs = _random_q(rng, n, s)
    qs[8:16] = 0.0
    qs[8:16, 0] = 5.0                        # only Q_0: the quirk decides
    states, rewards, discounts = _td_state(rng, n)
    loc = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    j_state = jnq.NeuralQState(jnp.asarray(loc), *([None] * 3),
                               jnp.asarray(states), jnp.asarray(rewards),
                               jnp.asarray(discounts), *([None] * 3))
    t_state = nq.NeuralQState(torch.from_numpy(loc), *([None] * 3),
                              torch.from_numpy(states),
                              torch.from_numpy(rewards),
                              torch.from_numpy(discounts), *([None] * 3))
    params, _ = jax_net
    net, js, scene = _net(params), jax_cornell_box(), cornell_box(device="cpu")
    want = A(jnq.compute_td_targets(params, js, j_state, GR, JDL(**DL)))
    got = nq.compute_td_targets(net, scene, t_state, GR, DeepLearningConfig(
        **DL)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    monkeypatch.setattr(jnq, "_q_forward", lambda *a: jnp.asarray(qs))
    monkeypatch.setattr(nq, "_q_forward", lambda *a: torch.from_numpy(qs))
    want = A(jnq.compute_td_targets(params, js, j_state, GR, JDL(**DL)))
    got = nq.compute_td_targets(net, scene, t_state, GR, DeepLearningConfig(
        **DL)).numpy()
    assert np.array_equal(got, want)
    live = states[8:16] != 1
    np.testing.assert_array_equal(
        got[8:16][live], (rewards + discounts * 5.0)[8:16][live])


def test_trace_step_matches_jax():
    """One trace step of the camera rays, then one of rays leaving the
    surfaces, from the same state: the port's default hit (kernel B4a's
    twin) against JAX's default (the exact f32 XLA sweep).  Both are
    exact f32 Moller-Trumbore in another algebra, so a near-tie may pick
    another triangle: states, bounces and hit positions agree on
    >= 99.9% of rays."""
    cfg, jcfg = RenderConfig(**KW), JCfg(**KW)
    dl, jdl = DeepLearningConfig(**DL), JDL(**DL)
    js, scene = jax_cornell_box(), cornell_box(device="cpu")
    j_st = jnq.init_rays(jax.random.PRNGKey(4), JCamera.create(CAM), jcfg)
    rng = np.random.default_rng(5)
    for bounce in (0, 1):
        t_st = nq.NeuralQState(*(torch.from_numpy(np.array(a))
                                 for a in j_st))
        j_new, j_go = jnq.trace_step(j_st, js, bounce, jcfg, jdl)
        t_new, t_go = nq.trace_step(t_st, scene, bounce, cfg, dl)
        assert bool(t_go) == bool(j_go)
        agree = np.ones(cfg.n_pixels, bool)
        for f in ("states", "bounces", "rewards", "discounts"):
            agree &= A(getattr(j_new, f)) == getattr(t_new, f).numpy()
        for f in ("loc", "normal", "throughput"):
            agree &= np.isclose(A(getattr(j_new, f)),
                                getattr(t_new, f).numpy(), rtol=1e-5,
                                atol=1e-5).all(-1)
        assert agree.mean() >= 0.999, (bounce, agree.mean())
        assert np.array_equal(t_new.prev_loc.numpy(), A(j_st.loc))
        # the next step's rays leave the surfaces the camera rays hit
        d = _unit(rng, cfg.n_pixels)
        nrm = A(j_new.normal)
        d = np.where((d * nrm).sum(-1, keepdims=True) < 0, -d, d)
        j_st = j_new._replace(direction=jnp.asarray(d),
                              states=jnp.zeros_like(j_new.states))


def test_respawn_only_moves_terminated():
    cfg = RenderConfig(**KW)
    g = torch.Generator().manual_seed(0)
    st = nq.init_rays(g, Camera.create(CAM), cfg)
    states = st.states.clone()
    states[0], states[1] = nq.TERMINATED, nq.LEARNING_ONLY
    st = st._replace(states=states)
    scene = cornell_box(device="cpu")
    out = nq.respawn_terminated(g, st, scene)
    assert int(out.states[0]) == nq.LEARNING_ONLY
    assert int(out.states[1]) == nq.LEARNING_ONLY
    assert (out.states[2:] == nq.ACTIVE).all()
    assert torch.equal(out.loc[1:], st.loc[1:])
    assert torch.equal(out.normal[1:], st.normal[1:])
    assert not torch.equal(out.loc[0], st.loc[0])
    # the new point lies on a surface triangle whose normal it takes
    n0 = out.normal[0]
    hit = (scene.normal[:scene.n_surfaces] == n0).all(-1)
    assert hit.any()
    dist = ((out.loc[0] - scene.v0[:scene.n_surfaces][hit]) * n0).sum(-1)
    assert float(dist.abs().min()) < 1e-5


# (label, lockstep?, train?, options)
FRAMES = [("lockstep-pretrained", True, False, {}),
          ("wavefront-pretrained-f32", False, False, {}),
          ("wavefront-pretrained-bf16", False, False, {"mlp_dtype": "bf16"}),
          ("wavefront-neural-q-minibatch", False, True, {}),
          ("wavefront-neural-q-fused", False, True,
           {"train_batching": "fused"}),
          ("lockstep-neural-q", True, True, {})]


FRAME_KW = dict(KW, samples_per_pixel=8, environment_light=0.5)
FRAME_SEEDS = 8


def _jax_frame(lockstep, train, kw, key, params, opt_state, eps):
    js, cam = jax_cornell_box(), JCamera.create(CAM)
    args = (js, cam, params)
    cfg, rl, dl = JCfg(**FRAME_KW), JRL(grid_resolution=GR), JDL(**DL)
    if not train:
        fn = j_pretrained if lockstep else jdw.render_frame_pretrained_wavefront
        return fn(key, *args, cfg, rl, dl, interpret=True, **kw)[0], None
    fn = jnq.render_frame_neural_q if lockstep else \
        jdw.render_frame_neural_q_wavefront
    out = fn(key, *args, opt_state, eps, cfg, rl, dl, interpret=True, **kw)
    return out[0], out[3]


@pytest.mark.parametrize("label,lockstep,train,kw", FRAMES,
                         ids=[f[0] for f in FRAMES])
def test_frame_matches_jax(jax_net, label, lockstep, train, kw):
    """The port's frame from JAX's initial net held to JAX's frames of
    FRAME_SEEDS other seeds (hold_to_jax); B4a's twin ran and nothing
    else; a training frame returns JAX's epsilon exactly and moves every
    layer, finitely."""
    params, opt_state = jax_net
    eps = 0.5
    js, j_eps = zip(*(_jax_frame(lockstep, train, kw,
                                 jax.random.PRNGKey(100 + i), params,
                                 opt_state, eps)
                      for i in range(FRAME_SEEDS)))
    net = _net(params)
    scene, cam = cornell_box(device="cpu"), Camera.create(CAM)
    cfg = RenderConfig(**FRAME_KW)
    rl = RadianceVolumeConfig(grid_resolution=GR)
    dl = DeepLearningConfig(**DL)
    before = [p.detach().clone() for p in net.parameters()]
    launches = ip.KERNEL_MAT.launches
    if not train:
        if lockstep:
            img, aux = render_frame_pretrained(3, scene, cam, net, cfg, rl,
                                               dl)
        else:
            img, aux = dw.render_frame_pretrained_wavefront(
                3, scene, cam, net, cfg, rl, dl, **kw)
    elif lockstep:
        img, _, state, eps_out, aux = nq.render_frame_neural_q(
            3, scene, cam, net, adam_init(net.parameters()), eps, cfg, rl, dl)
    else:
        img, _, state, eps_out, aux = dw.render_frame_neural_q_wavefront(
            3, scene, cam, net, adam_init(net.parameters()), eps, cfg, rl, dl,
            **kw)
    assert ip.KERNEL_MAT.launches == launches     # the CPU ran the twin
    assert torch.isfinite(img).all() and (img >= 0).all()
    hold_to_jax(img, js)
    assert float(torch.as_tensor(aux["avg_path_length"]).mean()) > 0
    moved = [not torch.equal(p, b) for p, b in zip(net.parameters(), before)]
    if train:
        assert eps_out == float(j_eps[0])
        assert all(moved) and all(torch.isfinite(p).all()
                                  for p in net.parameters())
        assert int(state.count) > 0
        assert torch.isfinite(aux["loss"]).all() and float(
            aux["loss"].sum()) > 0
    else:
        assert not any(moved)


def test_wavefront_epsilon_schedule_and_options():
    """Over three training frames from epsilon 1.0 the frame returns
    max(eps - decay * spp, eps_min) exactly as JAX computes it in f32
    (per-lane decay inside the frame); loss_rel is finite; a 64x64 frame
    drains through a second, 4x narrower phase; bad options raise."""
    jdl = JDL(**DL)
    dl = DeepLearningConfig(**DL)
    params, _ = jnq.init_neural_q(jax.random.PRNGKey(8), jax_cornell_box(),
                                  jdl, GR)
    net = _net(params)
    state = adam_init(net.parameters())
    scene, cam = cornell_box(device="cpu"), Camera.create(CAM)
    cfg, rl = RenderConfig(**KW), RadianceVolumeConfig(grid_resolution=GR)
    eps, j_eps = 1.0, jnp.float32(1.0)
    for f in range(3):
        _, _, _, eps, aux = dw.render_frame_neural_q_wavefront(
            10 + f, scene, cam, net, state, eps, cfg, rl, dl, pix_mux=4)
        j_eps = jnp.maximum(j_eps - jdl.epsilon_decay * KW[
            "samples_per_pixel"], jdl.epsilon_min)
        assert eps == float(j_eps)
        assert np.isfinite(float(aux["loss_rel"]))
    assert abs(eps - 0.88) < 1e-6
    wide = RenderConfig(width=64, height=64, samples_per_pixel=4,
                        max_ray_bounces=8)
    img, stats = dw.trace_frame_deep_wavefront(5, scene, cam, net, wide, rl,
                                               dl)
    assert stats["phase_widths"] == (4096, 1024)
    assert (stats["phase_iterations"] > 0).all()
    assert torch.isfinite(img).all() and float(img.mean()) > 0
    for bad in (dict(mlp_dtype="f16"), dict(train_batching="x"),
                dict(train=True, opt_state=state, mlp_dtype="bf16"),
                dict(train=True)):
        with pytest.raises(ValueError):
            dw.trace_frame_deep_wavefront(5, scene, cam, net, cfg, rl, dl,
                                          **bad)


SMALL = ["--width", "16", "--height", "16", "--spp", "2", "--bounces", "8",
         "--device", "cpu", "--grid-resolution", "6"]


@pytest.fixture(scope="module")
def deep_files(tmp_path_factory):
    """A model the JAX package saved (342 -> 16 -> 36), a Q table of 64
    volume rows, the scene's vertices and 4 probe points."""
    d = tmp_path_factory.mktemp("deep")
    js = jax_cornell_box()
    j_save_model(dq_init(jax.random.PRNGKey(0), 342, 36, (16,)),
                 str(d / "m.model"))
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1, 1, (64, 3))
    q = rng.uniform(0, 1, (64, 36))
    (d / "q.txt").write_text("36\n" + "".join(
        " ".join(f"{v:.6g}" for v in list(pos[i]) + list(q[i])) + "\n"
        for i in range(64)))
    j_save_vertices(js, str(d / "vertices.txt"))
    (d / "probe.txt").write_text("".join(
        " ".join(f"{v:.6g}" for v in p) + " 0 1 0\n" for p in pos[:4]))
    return d


@pytest.mark.parametrize("mode", ["neural-q-wavefront", "neural-q-lockstep",
                                  "pretrained", "q-probe", "distill"])
def test_cli_deep_modes(tmp_path, deep_files, mode, capsys):
    """The four deep modes at 16x16 on the CPU: neural-q writes its stats
    (one line per frame on the wavefront, per spp on the lockstep) and a
    model that the JAX package's model loads; pretrained renders the JAX
    package's model; q-probe writes rows summing to 1; distill prints
    its epochs and saves a model."""
    d = deep_files
    out, model = tmp_path / "r.png", tmp_path / "saved.model"
    if mode.startswith("neural-q"):
        stats = tmp_path / "stats.txt"
        argv = ["--mode", "neural-q", "--impl", mode.split("-")[-1],
                "--frames", "2", "--stats", str(stats), "--save-model",
                str(model)]
    elif mode == "pretrained":
        argv = ["--mode", "pretrained", "--model", str(d / "m.model")]
    elif mode == "q-probe":
        argv = ["--mode", "q-probe", "--model", str(d / "m.model"),
                "--probe", str(d / "probe.txt"), "--out-probe",
                str(tmp_path / "sel.txt")]
    else:
        argv = ["--mode", "distill", "--load-q", str(d / "q.txt"),
                "--vertices", str(d / "vertices.txt"), "--epochs", "2",
                "--save-model", str(model)]
    assert render.main(argv + SMALL + ["--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    if mode in ("q-probe", "distill"):
        assert not out.exists()
    else:
        img = read_png(str(out))
        assert img.shape == (16, 16, 3) and img.max() > 0
    if mode.startswith("neural-q"):
        rows = np.loadtxt(stats)
        assert rows.shape == ((2, 3) if mode.endswith("wavefront")
                              else (4, 3))
        assert sum(ln.startswith("frame ") for ln in lines) == 2
    if mode == "q-probe":
        rows = np.loadtxt(tmp_path / "sel.txt")
        assert rows.shape == (4, 42)
        np.testing.assert_allclose(rows[:, 6:].sum(-1), 1.0, atol=1e-4)
    if mode == "distill":
        assert sum(ln.startswith("epoch ") for ln in lines) == 2
    if model.exists():
        from rlrpt_tpu.nn.dynet_io import load_dynet_model
        layers = load_dynet_model(str(model)).layers
        assert layers[0].w.shape[1] == 342
    with pytest.raises(ValueError):
        render.main(["--mode", "pretrained", "--impl", "lockstep",
                     "--mlp-dtype", "bf16"] + SMALL + ["--out", str(out)])
