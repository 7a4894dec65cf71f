"""rlrpt_tpu_torch's deep-Q family against rlrpt_tpu's on an OBJ scene on
the CPU: the generated torus room at 8 x 6 quads (96 + 10 + 2 = 108
triangles, so the relative-vertex input is 972 wide, against Cornell's
342), written by the port's generator and loaded by each package's own
OBJ importer.

Cases: forward_relative and its gradients against dq_apply_relative and
jax.grad; one train_on_batches minibatch against JAX's; the wavefront
frames (pretrained f32 and bf16, neural-q in minibatches) held to JAX's
frames of other seeds (_torch_parity.hold_to_jax; JAX's Pallas hit in
interpret mode); the DyNet file, byte for byte against JAX's writer and
read by JAX's loader; two distillation epochs on JAX's permutations and
the q-probe rows of the distilled net; the four deep CLI modes on the
scene.  Tolerances are stated in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlrpt_tpu.camera import Camera as JCamera
from rlrpt_tpu.config import DeepLearningConfig as JDL
from rlrpt_tpu.config import RadianceVolumeConfig as JRL
from rlrpt_tpu.config import RenderConfig as JCfg
from rlrpt_tpu.deep import deep_wavefront as jdw
from rlrpt_tpu.deep import distill as jdistill
from rlrpt_tpu.deep import neural_q as jnq
from rlrpt_tpu.deep.q_probe import probe_q_values as j_probe
from rlrpt_tpu.nn import dynet_io as jio
from rlrpt_tpu.nn.dq_network import (DQNetworkParams, dq_apply_relative,
                                     dq_init)
from rlrpt_tpu.nn.fc_layer import FCParams
from rlrpt_tpu.scene.scene import save_vertices_to_file as j_save_vertices
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import (DeepLearningConfig, RadianceVolumeConfig,
                                    RenderConfig)
from rlrpt_tpu_torch.deep import deep_wavefront as dw
from rlrpt_tpu_torch.deep import distill, neural_q
from rlrpt_tpu_torch.deep.q_probe import probe_q_values
from rlrpt_tpu_torch.nn import dynet_io
from rlrpt_tpu_torch.nn.adam import adam_init
from rlrpt_tpu_torch.ops import intersect_pallas as ip
from rlrpt_tpu_torch.scene import generated, presets
from rlrpt_tpu_torch.scene.scene import save_vertices_to_file
from rlrpt_tpu_torch.tools import render
from rlrpt_tpu_torch.utils.convert import (adam_state_from_numpy,
                                           dq_network_from_numpy,
                                           dq_network_to_numpy)
from rlrpt_tpu_torch.utils.image import read_png
from _torch_parity import (hold_to_jax, jax_preset,  # noqa: F401
                           one_torch_thread)

A = np.asarray
FULL = (200, 300, 200)     # the reference's hidden widths; 144 actions
N_IN = 972                 # 9 x 108 triangles
GR = 6
DL = dict(batch_size=256, hidden_sizes=(32, 48, 32))


@pytest.fixture(scope="module")
def torus(tmp_path_factory):
    """(port preset, port scene, JAX scene) of the 8 x 6 torus room."""
    p = generated.torus_room(
        tmp_path_factory.mktemp("torus") / "torus_8x6.obj", 8, 6)
    s_t, s_j = p.load(device="cpu"), jax_preset(p).load()
    assert s_t.n_triangles == s_j.n_triangles == 108
    assert np.array_equal(s_t.vertices_flat.numpy(), A(s_j.vertices_flat))
    assert s_t.vertices_count == s_j.vertices_count == N_IN
    return p, s_t, s_j


def _layers(params):
    return [(A(lp.w), A(lp.b)) for lp in params.layers]


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(A(a), A(b), rtol=rtol, atol=atol)


def test_forward_relative_and_gradients_match_jax(torus):
    """The full-width net (972 -> 200 -> 300 -> 200 -> 144) on 512
    positions in the room: Q within rtol 1e-5 (atol 1e-5 for ReLU outputs
    near 0), and the gradients of sum(c * Q) for random c, through the
    factored first layer, within rtol 1e-5 of jax.grad's (atol 1e-5 of
    each tensor's largest entry: float32 sums over 512 rows in another
    order)."""
    _, _, s_j = torus
    verts = np.array(s_j.vertices_flat)
    params = dq_init(jax.random.PRNGKey(3), N_IN, 144, FULL)
    net = dq_network_from_numpy(_layers(params))
    rng = np.random.default_rng(4)
    pos = rng.uniform(-0.9, 0.9, (512, 3)).astype(np.float32)
    c = rng.normal(size=(512, 144)).astype(np.float32)
    j_q = dq_apply_relative(params, jnp.asarray(verts), jnp.asarray(pos))
    q = net.forward_relative(torch.from_numpy(verts), torch.from_numpy(pos))
    _close(q.detach(), j_q, 1e-5, 1e-5)
    assert float((q > 0).float().mean()) > 0.2     # the ReLU passes some
    j_g = jax.grad(lambda p: jnp.sum(jnp.asarray(c) * dq_apply_relative(
        p, jnp.asarray(verts), jnp.asarray(pos))))(params)
    grads = torch.autograd.grad((torch.from_numpy(c) * q).sum(),
                                list(net.parameters()))
    assert grads[0].shape == (200, N_IN)
    for g, jg in zip(grads, jax.tree_util.tree_leaves(j_g)):
        jg = A(jg)
        _close(g, jg, 1e-5, 1e-5 * float(np.abs(jg).max()))


def test_train_on_batches_minibatch_matches_jax(torus):
    """One 4096-ray minibatch of train_on_batches on the full-width net,
    from optax's own Adam state after one step (moments live), a quarter
    of the rays masked: the parameters within rtol 1e-5 of JAX's (atol
    1e-6, a thousandth of the learning rate: a step moves a weight by up
    to about lr, and where the two steps' gradients nearly cancel in the
    first moment, float32 rounding of a gradient moves that step by a
    part in a thousand), the moments within rtol 1e-4 (they carry the
    gradients' rounding), the loss within rtol 1e-5, the step counted."""
    _, s_t, s_j = torus
    dl, jdl = DeepLearningConfig(), JDL()
    assert dl.batch_size == jdl.batch_size == 4096
    params, opt_state = jnq.init_neural_q(jax.random.PRNGKey(6), s_j, jdl,
                                          12)
    assert params.layers[0].w.shape == (200, N_IN)
    optimizer = jnq.default_optimizer(jdl)
    rng = np.random.default_rng(7)
    verts = s_j.vertices_flat
    loc0 = rng.uniform(-0.9, 0.9, (256, 3)).astype(np.float32)
    g = jax.grad(lambda p: jnp.sum(dq_apply_relative(
        p, verts, jnp.asarray(loc0)) ** 2))(params)
    upd, opt_state = optimizer.update(g, opt_state, params)
    params = optax.apply_updates(params, upd)

    n = 4096
    loc = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    act = rng.integers(0, 144, n).astype(np.int64)
    td = rng.uniform(0, 50, n).astype(np.float32)
    w = (rng.random(n) > 0.25).astype(np.float32)
    adam = opt_state[0]
    net = dq_network_from_numpy(_layers(params))
    state = adam_state_from_numpy(
        adam.count, [A(x) for x in jax.tree_util.tree_leaves(adam.mu)],
        [A(x) for x in jax.tree_util.tree_leaves(adam.nu)])
    j_p, j_o, j_loss = jnq.train_on_batches(
        params, opt_state, optimizer, s_j, jnp.asarray(loc),
        jnp.asarray(act), jnp.asarray(td), jdl, weights=jnp.asarray(w))
    t = torch.from_numpy
    loss = neural_q.train_on_batches(net, state, s_t, t(loc), t(act), t(td),
                                     dl, weights=t(w))
    _close(loss, j_loss, 1e-5, 0)
    assert int(state.count) == int(j_o[0].count) == 2
    for p, jp in zip(net.parameters(), jax.tree_util.tree_leaves(j_p)):
        _close(p.detach(), jp, 1e-5, 1e-3 * dl.learning_rate)
    for a, b in zip(state.mu + state.nu,
                    jax.tree_util.tree_leaves(j_o[0].mu)
                    + jax.tree_util.tree_leaves(j_o[0].nu)):
        _close(a, b, 1e-4, 1e-5 * float(np.abs(A(b)).max()))


# (label, train?, options): the wavefront frames on the OBJ
FRAMES = [("pretrained-f32", False, {}),
          ("pretrained-bf16", False, {"mlp_dtype": "bf16"}),
          ("neural-q-minibatch", True, {})]
FRAME_KW = dict(width=24, height=24, samples_per_pixel=8, max_ray_bounces=8,
                ray_tile=1024, environment_light=0.5)
FRAME_SEEDS = 8


@pytest.fixture(scope="module")
def jax_net(torus):
    """JAX's initial 972-32-48-32-36 net and optax state (seed 7)."""
    return jnq.init_neural_q(jax.random.PRNGKey(7), torus[2], JDL(**DL), GR)


@pytest.mark.parametrize("label,train,kw", FRAMES, ids=[f[0] for f in FRAMES])
def test_wavefront_frame_matches_jax(torus, jax_net, label, train, kw):
    """The port's wavefront frame on the OBJ from JAX's initial net, held
    to JAX's frames of FRAME_SEEDS other seeds (hold_to_jax: the frame
    mean within 4 standard deviations, the 3x3 block means' mean squared
    z below 8, the mean absolute distance from JAX's average at most 1.3x
    JAX's own); B4a's twin ran, nothing was launched; a training frame
    returns JAX's epsilon exactly and moves every layer, finitely."""
    p, s_t, s_j = torus
    params, opt_state = jax_net
    cfg, rl, dl = (RenderConfig(**FRAME_KW),
                   RadianceVolumeConfig(grid_resolution=GR),
                   DeepLearningConfig(**DL))
    jargs = (s_j, JCamera.create(p.camera_position), params)
    jcfg = (JCfg(**FRAME_KW), JRL(grid_resolution=GR), JDL(**DL))
    eps = 0.5
    js, j_eps = [], None
    for i in range(FRAME_SEEDS):
        key = jax.random.PRNGKey(100 + i)
        if train:
            out = jdw.render_frame_neural_q_wavefront(
                key, *jargs, opt_state, eps, *jcfg, interpret=True, **kw)
            j_eps = float(out[3])
        else:
            out = jdw.render_frame_pretrained_wavefront(
                key, *jargs, *jcfg, interpret=True, **kw)
        js.append(out[0])
    net = dq_network_from_numpy(_layers(params))
    cam = Camera.create(p.camera_position)
    before = [q.detach().clone() for q in net.parameters()]
    launches = ip.KERNEL_MAT.launches
    if train:
        img, _, state, eps_out, aux = dw.render_frame_neural_q_wavefront(
            3, s_t, cam, net, adam_init(net.parameters()), eps, cfg, rl, dl,
            **kw)
    else:
        img, aux = dw.render_frame_pretrained_wavefront(
            3, s_t, cam, net, cfg, rl, dl, **kw)
    assert ip.KERNEL_MAT.launches == launches     # the CPU ran the twin
    assert torch.isfinite(img).all() and (img >= 0).all()
    hold_to_jax(img, js)
    assert float(aux["avg_path_length"]) > 1.0
    moved = [not torch.equal(q, b) for q, b in zip(net.parameters(), before)]
    if train:
        assert eps_out == j_eps
        assert all(moved) and int(state.count) > 0
        assert all(torch.isfinite(q).all() for q in net.parameters())
        assert np.isfinite(float(aux["loss"])) and float(aux["loss"]) > 0
    else:
        assert not any(moved)


def test_dynet_file_matches_jax_at_obj_width(torus, tmp_path):
    """The full-width 972-input net: the port's file is JAX's writer's
    byte for byte, JAX's loader reads it back to the same float32 arrays,
    and the port's loader reads JAX's file to them (exact)."""
    params = dq_init(jax.random.PRNGKey(5), N_IN, 144, FULL)
    net = dq_network_from_numpy(_layers(params))
    t_path, j_path = tmp_path / "port.model", tmp_path / "jax.model"
    dynet_io.save_dynet_model(net, str(t_path))
    jio.save_dynet_model(params, str(j_path))
    assert t_path.read_bytes() == j_path.read_bytes()
    assert t_path.read_text().splitlines()[0].startswith(
        "#Parameter# /_0 {200,972} ")
    for (w, b), (jw, jb) in zip(_layers(jio.load_dynet_model(str(t_path))),
                                _layers(params)):
        assert np.array_equal(w, jw) and np.array_equal(b, jb)
    back = dynet_io.load_dynet_model(str(j_path), device="cpu")
    for (w, b), (jw, jb) in zip(dq_network_to_numpy(back), _layers(params)):
        assert np.array_equal(w, jw) and np.array_equal(b, jb)


def _teacher_table(s_j, n, n_act, seed):
    """n random room positions and a teacher net's Q rows for them."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    teacher = dq_init(jax.random.PRNGKey(seed), N_IN, n_act, (8,))
    return pos, np.array(dq_apply_relative(teacher, s_j.vertices_flat,
                                           jnp.asarray(pos)))


def test_distill_two_epochs_and_probe_match_jax(torus):
    """Two distillation epochs (240 rows, batch 64) of the 972-input net
    on JAX's permutations, Adam state carried over: each epoch's summed
    loss within rtol 1e-5 and the parameters within rtol 1e-4 of JAX's
    (as the Cornell epoch test), the test MSE within rtol 1e-4; then the
    distilled net's q-probe rows at 8 positions within rtol 2e-5 (atol
    1e-6) of JAX's, summing to 1 within 1e-4."""
    _, s_t, s_j = torus
    verts = s_j.vertices_flat
    pos, tgt = _teacher_table(s_j, 240, 36, 10)
    params = dq_init(jax.random.PRNGKey(9), N_IN, 36, (32, 48, 32))
    net = dq_network_from_numpy(_layers(params))
    state = adam_init(net.parameters())
    j_o = optax.adam(1e-3).init(params)
    tv = torch.from_numpy(np.array(verts))
    for epoch in range(2):
        key = jax.random.PRNGKey(11 + epoch)
        params, j_o, j_loss = jdistill.train_epoch(
            key, params, j_o, verts, jnp.asarray(pos), jnp.asarray(tgt), 64)
        loss = distill.train_epoch(
            net, state, tv, torch.from_numpy(pos), torch.from_numpy(tgt), 64,
            perm=torch.from_numpy(np.array(
                jax.random.permutation(key, 240))).long())
        _close(loss, j_loss, 1e-5, 0)
        for q, jq in zip(net.parameters(), jax.tree_util.tree_leaves(params)):
            _close(q.detach(), jq, 1e-4, 1e-6)
    _close(distill.eval_mse(net, tv, torch.from_numpy(pos),
                            torch.from_numpy(tgt)),
           jdistill.eval_mse(params, verts, jnp.asarray(pos),
                             jnp.asarray(tgt)), 1e-4, 0)
    probes = pos[:8]
    rows = probe_q_values(net, s_t, probes)
    _close(rows, j_probe(params, s_j, probes), 2e-5, 1e-6)
    np.testing.assert_allclose(rows.sum(-1), 1.0, atol=1e-4)


SMALL = ["--width", "16", "--height", "16", "--spp", "2", "--bounces", "8",
         "--device", "cpu", "--grid-resolution", "6"]


@pytest.fixture(scope="module")
def obj_files(torus, tmp_path_factory):
    """The scene's vertices.txt (JAX's writer; the port's is byte-equal),
    a Q table of 64 rows from a teacher net, 4 probe points and a
    972-input model saved by JAX."""
    d = tmp_path_factory.mktemp("deep_obj")
    _, s_t, s_j = torus
    j_save_vertices(s_j, str(d / "vertices.txt"))
    save_vertices_to_file(s_t, str(d / "port_vertices.txt"))
    assert (d / "vertices.txt").read_bytes() == (
        d / "port_vertices.txt").read_bytes()
    pos, q = _teacher_table(s_j, 64, 36, 12)
    (d / "q.txt").write_text("36\n" + "".join(
        " ".join(f"{v:.6g}" for v in list(pos[i]) + list(q[i])) + "\n"
        for i in range(64)))
    (d / "probe.txt").write_text("".join(
        " ".join(f"{v:.6g}" for v in p) + " 0 1 0\n" for p in pos[:4]))
    jio.save_dynet_model(dq_init(jax.random.PRNGKey(0), N_IN, 36, (16,)),
                         str(d / "m.model"))
    return d


@pytest.mark.parametrize("mode", ["neural-q", "pretrained", "distill",
                                  "q-probe"])
def test_cli_deep_modes_on_obj(torus, obj_files, tmp_path, monkeypatch, mode,
                               capsys):
    """The four deep modes through the CLI with --scene set to the OBJ
    preset, at 16x16 on the CPU: neural-q trains the 972-input net for 2
    frames and saves a model JAX loads; pretrained renders JAX's model;
    distill prints 2 epochs and saves a 972-input model; q-probe writes
    rows summing to 1 within 1e-4."""
    p = torus[0]
    monkeypatch.setitem(presets.PRESETS, p.name, p)
    d, out = obj_files, tmp_path / "r.png"
    model = tmp_path / "saved.model"
    argv = {"neural-q": ["--mode", "neural-q", "--frames", "2",
                         "--save-model", str(model)],
            "pretrained": ["--mode", "pretrained", "--model",
                           str(d / "m.model")],
            "distill": ["--mode", "distill", "--load-q", str(d / "q.txt"),
                        "--vertices", str(d / "vertices.txt"), "--epochs",
                        "2", "--save-model", str(model)],
            "q-probe": ["--mode", "q-probe", "--model", str(d / "m.model"),
                        "--probe", str(d / "probe.txt"), "--out-probe",
                        str(tmp_path / "sel.txt")]}[mode]
    assert render.main(argv + ["--scene", p.name] + SMALL
                       + ["--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    if mode in ("neural-q", "pretrained"):
        img = read_png(str(out))
        assert img.shape == (16, 16, 3) and img.max() > 0
    if mode == "neural-q":
        assert sum(ln.startswith("frame ") for ln in lines) == 2
    if mode == "distill":
        assert sum(ln.startswith("epoch ") for ln in lines) == 2
    if mode == "q-probe":
        rows = np.loadtxt(tmp_path / "sel.txt")
        assert rows.shape == (4, 42)
        np.testing.assert_allclose(rows[:, 6:].sum(-1), 1.0, atol=1e-4)
    if model.exists():
        layers = jio.load_dynet_model(str(model)).layers
        assert layers[0].w.shape[1] == N_IN


def _special_float32s() -> np.ndarray:
    """Values where a decimal writer or reader could go wrong: both
    zeros, subnormals, every power of two, the float32s next to every
    power of ten, 9-digit roundings that carry into the next decade,
    exact decimal ties (2^-14 = 6.103515625e-05), and 1 M values drawn
    at several scales."""
    f32 = np.float32
    two = [np.ldexp(f32(1.0), k) for k in range(-149, 128)]
    ten = [f32(10.0) ** k for k in range(-45, 39)]
    near = [np.nextafter(t, f32(s) * np.inf, dtype=f32)
            for t in ten if np.isfinite(t) for s in (1, -1)]
    rng = np.random.default_rng(13)
    scales = rng.normal(size=(8, 125_000)) * 10.0 ** np.arange(
        -40, 40, 10)[:, None]
    vals = np.concatenate([
        [0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, 1.1754944e-38,
         3.4028235e38, -3.4028235e38, 9.9999999e-5, 0.99999999995,
         6.103515625e-05, 2.384185791015625e-07],
        two, ten, near, scales.reshape(-1)]).astype(f32)
    return np.concatenate([vals, -vals])


def test_dynet_text_is_the_reference_format_at_every_value(tmp_path):
    """A net whose weights are _special_float32s: the port's file is the
    JAX writer's byte for byte, and the port's loader gives back each
    value's bits, -0.0 and subnormals included."""
    x = _special_float32s()
    w, b = x.reshape(2, -1), x[:2]
    t_path, j_path = tmp_path / "port.model", tmp_path / "jax.model"
    dynet_io.save_dynet_model(dq_network_from_numpy([(w, b)]), str(t_path))
    jio.save_dynet_model(DQNetworkParams(layers=(FCParams(w=w, b=b),)),
                         str(j_path))
    assert t_path.read_bytes() == j_path.read_bytes()
    (bw, bb), = dq_network_to_numpy(
        dynet_io.load_dynet_model(str(t_path), device="cpu"))
    assert np.array_equal(bw.view(np.int32), w.view(np.int32))
    assert np.array_equal(bb.view(np.int32), b.view(np.int32))
