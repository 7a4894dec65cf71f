"""rlrpt_tpu_torch's deep-Q network pieces against rlrpt_tpu's on the CPU:
the FC layer, the DQN and its factored first layer, one TD minibatch's
gradients, Adam against optax (with the masked minibatch), DyNet files,
q-probe rows, a distillation epoch, the vertices file and the configs.

Inputs come from numpy with fixed seeds; both sides get the same weights
through utils/convert.py.  Tolerances: forwards rtol 1e-5 (float32 sums
in another order; atol 1e-5 for ReLU outputs near 0), gradients and
the moments they feed rtol 1e-4, Adam's parameters rtol 1e-5; files and
masked steps exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlrpt_tpu import config as jconfig
from rlrpt_tpu.deep import distill as jdistill
from rlrpt_tpu.deep import neural_q as jnq
from rlrpt_tpu.deep.q_probe import probe_q_values as j_probe
from rlrpt_tpu.deep.q_probe import save_selected_q_values_nn as j_save_probe
from rlrpt_tpu.nn import dynet_io as jio
from rlrpt_tpu.nn.dq_network import dq_apply, dq_apply_relative, dq_init
from rlrpt_tpu.nn.encoding import relative_vertex_encoding as j_encoding
from rlrpt_tpu.nn.fc_layer import FCParams, fc_apply
from rlrpt_tpu.scene import cornell_box as jax_cornell_box
from rlrpt_tpu.scene.scene import save_vertices_to_file as j_save_vertices
from rlrpt_tpu_torch import config
from rlrpt_tpu_torch.deep import distill, neural_q
from rlrpt_tpu_torch.deep.q_probe import (probe_q_values,
                                          save_selected_q_values_nn)
from rlrpt_tpu_torch.nn import dynet_io
from rlrpt_tpu_torch.nn.adam import adam_init, adam_update
from rlrpt_tpu_torch.nn.encoding import relative_vertex_encoding
from rlrpt_tpu_torch.nn.fc_layer import (LINEAR, RELU, SIGMOID, SOFTMAX,
                                         TANH, FCLayer)
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.scene.scene import (load_vertices_from_file,
                                         save_vertices_to_file)
from rlrpt_tpu_torch.utils.convert import (adam_state_from_numpy,
                                           dq_network_from_numpy,
                                           dq_network_to_numpy)
from _torch_parity import one_torch_thread  # noqa: F401

A = np.asarray
FULL = (200, 300, 200)     # the reference's hidden widths; 144 actions


def _layers(params):
    return [(A(lp.w), A(lp.b)) for lp in params.layers]


@pytest.fixture(scope="module")
def full_net():
    """JAX's full-width Cornell DQN (342 -> 200 -> 300 -> 200 -> 144) and
    the port's copy, with the scene's vertices and 256 positions."""
    js = jax_cornell_box()
    verts = np.array(js.vertices_flat)
    params = dq_init(jax.random.PRNGKey(0), verts.shape[0], 144, FULL)
    pos = np.random.default_rng(1).uniform(-1, 1, (256, 3)).astype(
        np.float32)
    return params, dq_network_from_numpy(_layers(params)), verts, pos


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(A(a), A(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("act", [LINEAR, RELU, SIGMOID, TANH, SOFTMAX],
                         ids=["linear", "relu", "sigmoid", "tanh", "softmax"])
def test_fc_activations_match_jax(act):
    rng = np.random.default_rng(act)
    w = rng.normal(size=(24, 40)).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    x = rng.normal(size=(64, 40)).astype(np.float32)
    layer = FCLayer(40, 24, act)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        layer.bias.copy_(torch.from_numpy(b))
    want = fc_apply(FCParams(jnp.asarray(w), jnp.asarray(b)), jnp.asarray(x),
                    activation=act)
    _close(layer(torch.from_numpy(x)).detach(), want)


def test_fc_init_and_dropout():
    """Glorot-uniform weights in +-sqrt(6/(in+out)), zero bias (not
    nn.Linear's init); eval scales by (1 - p) as JAX does; training keeps
    about 1 - p of the units and zeroes the rest."""
    g = torch.Generator().manual_seed(0)
    layer = FCLayer(342, 200, RELU, dropout=0.25, generator=g)
    limit = np.sqrt(6.0 / 542)
    w = layer.weight.detach()
    assert layer.weight.shape == (200, 342)
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.99 * limit
    assert abs(float(w.std()) - limit / np.sqrt(3)) < 0.01 * limit
    assert torch.equal(layer.bias, torch.zeros(200))
    x = np.random.default_rng(2).normal(size=(128, 342)).astype(np.float32)
    layer.eval()
    want = fc_apply(FCParams(jnp.asarray(A(w)), jnp.zeros(200)),
                    jnp.asarray(x), RELU, dropout=0.25, training=False)
    out = layer(torch.from_numpy(x)).detach()
    _close(out, want)
    layer.train()
    y = layer(torch.from_numpy(x), generator=g).detach()
    full = out / 0.75
    kept = (y != 0) & (full != 0)
    assert torch.allclose(y[kept], full[kept], rtol=1e-6)
    live = full != 0
    assert abs(float(kept.sum()) / float(live.sum()) - 0.75) < 0.02


def test_forward_matches_jax(full_net):
    """forward on the materialised encoding and forward_relative on the
    positions, at full width, against dq_apply / dq_apply_relative."""
    params, net, verts, pos = full_net
    jv, jp = jnp.asarray(verts), jnp.asarray(pos)
    tv, tp = torch.from_numpy(verts), torch.from_numpy(pos)
    with torch.no_grad():
        rel = net.forward_relative(tv, tp)
        mat = net(relative_vertex_encoding(tv, tp))
    _close(rel, dq_apply_relative(params, jv, jp))
    _close(mat, dq_apply(params, j_encoding(jv, jp)))
    assert rel.shape == (256, 144) and float(rel.max()) > 0


def test_factored_form_equals_materialised(full_net):
    """The port's encoding is JAX's exactly; the factored first layer gives
    the materialised form's outputs and gradients."""
    _, net, verts, pos = full_net
    tv, tp = torch.from_numpy(verts), torch.from_numpy(pos[:32])
    enc = relative_vertex_encoding(tv, tp)
    assert np.array_equal(enc.numpy(),
                          A(j_encoding(jnp.asarray(verts),
                                       jnp.asarray(pos[:32]))))
    tgt = torch.from_numpy(np.random.default_rng(3).random((32, 144))
                           .astype(np.float32))
    params = list(net.parameters())
    g_fac = torch.autograd.grad(
        ((net.forward_relative(tv, tp) - tgt) ** 2).sum(), params)
    g_mat = torch.autograd.grad(((net(enc) - tgt) ** 2).sum(), params)
    with torch.no_grad():
        _close(net.forward_relative(tv, tp), net(enc), rtol=2e-4, atol=2e-4)
    for a, b in zip(g_fac, g_mat):
        _close(a, b, rtol=1e-3, atol=1e-3)


def _td_batch(n=256, s=144, seed=4):
    rng = np.random.default_rng(seed)
    loc = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    act = rng.integers(0, s, n)
    td = rng.uniform(0, 5, n).astype(np.float32)
    w = (rng.random(n) < 0.7).astype(np.float32)
    return loc, act, td, w


def test_td_minibatch_gradients_match_jax(full_net):
    """One TD minibatch, sum(w * (td - Q(s, a))^2), at full width:
    the port's loss and autograd gradients against jax.value_and_grad."""
    params, net, verts, _ = full_net
    loc, act, td, w = _td_batch()
    js = jax_cornell_box()

    def jloss(p):
        q = dq_apply_relative(p, js.vertices_flat, jnp.asarray(loc))
        qa = jnp.take_along_axis(q, jnp.asarray(act)[:, None], 1)[:, 0]
        return jnp.sum(jnp.asarray(w) * (jnp.asarray(td) - qa) ** 2)

    j_l, j_g = jax.value_and_grad(jloss)(params)
    loss = neural_q.td_loss(net, cornell_box(device="cpu"),
                            torch.from_numpy(loc),
                            torch.from_numpy(act), torch.from_numpy(td),
                            torch.from_numpy(w), config.DeepLearningConfig())
    grads = torch.autograd.grad(loss, list(net.parameters()))
    _close(loss.detach(), j_l, rtol=1e-5, atol=0)
    for g, jg in zip(grads, jax.tree_util.tree_leaves(j_g)):
        scale = float(np.abs(A(jg)).max())
        _close(g, jg, rtol=1e-4, atol=1e-5 * scale)


def test_adam_matches_optax(full_net):
    """5 Adam steps from random gradients (DyNet's settings) against
    optax.adam: parameters and moments within rtol 1e-5, the step count
    equal."""
    params, _, _, _ = full_net
    net = dq_network_from_numpy(_layers(params))
    dl = config.DeepLearningConfig()
    opt = optax.adam(dl.learning_rate, b1=dl.adam_b1, b2=dl.adam_b2,
                     eps=dl.adam_eps)
    j_state = opt.init(params)
    state = adam_init(net.parameters())
    rng = np.random.default_rng(5)
    for _ in range(5):
        grads = [rng.normal(size=p.shape).astype(np.float32)
                 for p in net.parameters()]
        updates, j_state = opt.update(
            jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(params),
                [jnp.asarray(g) for g in grads]), j_state, params)
        params = optax.apply_updates(params, updates)
        adam_update(list(net.parameters()), [torch.from_numpy(g)
                                             for g in grads], state,
                    dl.learning_rate, dl.adam_b1, dl.adam_b2, dl.adam_eps)
    for p, jp in zip(net.parameters(), jax.tree_util.tree_leaves(params)):
        _close(p.detach(), jp, rtol=1e-5, atol=1e-7)
    adam = j_state[0]
    assert int(state.count) == int(adam.count) == 5
    for a, b in zip(state.mu + state.nu,
                    jax.tree_util.tree_leaves(adam.mu)
                    + jax.tree_util.tree_leaves(adam.nu)):
        _close(a, b, rtol=1e-5, atol=1e-9)


def _bits(tensors):
    return [t.detach().clone().view(torch.int32) for t in tensors]


def test_train_on_batches_matches_jax_and_skips_empty_batches():
    """train_on_batches over 700 rays in 256-ray minibatches (the middle
    one all masked) from optax's own Adam state after one step: JAX's
    parameters and state within rtol 1e-5 and two more steps counted.  A
    call whose weights are all zero leaves the network and the state bit
    for bit as they were."""
    js = jax_cornell_box()
    dl = config.DeepLearningConfig(batch_size=256, hidden_sizes=(32, 48, 32))
    jdl = jconfig.DeepLearningConfig(batch_size=256,
                                     hidden_sizes=(32, 48, 32))
    params, opt_state = jnq.init_neural_q(jax.random.PRNGKey(6), js, jdl, 6)
    optimizer = jnq.default_optimizer(jdl)
    loc, act, td, w = _td_batch(256, 36, 7)
    g = jax.grad(lambda p: jnp.sum(dq_apply_relative(
        p, js.vertices_flat, jnp.asarray(loc)) ** 2))(params)
    upd, opt_state = optimizer.update(g, opt_state, params)
    params = optax.apply_updates(params, upd)     # count 1, moments live

    loc, act, td, w = _td_batch(700, 36, 8)
    w[256:512] = 0.0
    adam = opt_state[0]
    net = dq_network_from_numpy(_layers(params))
    state = adam_state_from_numpy(adam.count,
                                  [A(x) for x in jax.tree_util.tree_leaves(
                                      adam.mu)],
                                  [A(x) for x in jax.tree_util.tree_leaves(
                                      adam.nu)])
    j_p, j_o, j_loss = jnq.train_on_batches(
        params, opt_state, optimizer, js, jnp.asarray(loc), jnp.asarray(act),
        jnp.asarray(td), jdl, weights=jnp.asarray(w))
    scene = cornell_box(device="cpu")
    t = torch.from_numpy
    loss = neural_q.train_on_batches(net, state, scene, t(loc), t(act), t(td),
                                     dl, weights=t(w))
    _close(loss, j_loss, rtol=1e-5, atol=0)
    assert int(state.count) == int(j_o[0].count) == 3
    for p, jp in zip(net.parameters(), jax.tree_util.tree_leaves(j_p)):
        _close(p.detach(), jp, rtol=1e-5, atol=1e-7)
    # the moments carry the gradients' rounding (rtol 1e-4, as above)
    for a, b in zip(state.mu + state.nu,
                    jax.tree_util.tree_leaves(j_o[0].mu)
                    + jax.tree_util.tree_leaves(j_o[0].nu)):
        _close(a, b, rtol=1e-4, atol=1e-5 * float(np.abs(A(b)).max()))

    before = _bits(list(net.parameters()) + list(state.mu + state.nu)
                   + [state.count])
    loss = neural_q.train_on_batches(net, state, scene, t(loc), t(act),
                                     t(td), dl, weights=torch.zeros(700))
    after = _bits(list(net.parameters()) + list(state.mu + state.nu)
                  + [state.count])
    assert float(loss) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_dynet_files_cross_load(tmp_path, full_net):
    """A file JAX writes loads in the port to the same float32 arrays; the
    port writes the same bytes for the same parameters, and JAX loads the
    port's file."""
    params, net, verts, pos = full_net
    j_path, t_path = tmp_path / "jax.model", tmp_path / "port.model"
    jio.save_dynet_model(params, str(j_path))
    loaded = dynet_io.load_dynet_model(str(j_path), device="cpu")
    for (w, b), (jw, jb) in zip(dq_network_to_numpy(loaded), _layers(params)):
        assert np.array_equal(w, jw) and np.array_equal(b, jb)
    dynet_io.save_dynet_model(net, str(t_path))
    assert t_path.read_bytes() == j_path.read_bytes()
    back = jio.load_dynet_model(str(t_path))
    for (w, b), (jw, jb) in zip(_layers(back), _layers(params)):
        assert np.array_equal(w, jw) and np.array_equal(b, jb)
    header = t_path.read_text().splitlines()[0]
    assert header == "#Parameter# /_0 {200,342} 1094401 ZERO_GRAD"


@pytest.mark.parametrize("fault", ["count", "bytes", "header"])
def test_dynet_loader_rejects_bad_files(tmp_path, fault):
    path = tmp_path / "bad.model"
    data = "+1.00000000e+00 +2.00000000e+00 "
    header = {"count": "#Parameter# /_0 {3} 33 ZERO_GRAD",
              "bytes": "#Parameter# /_0 {2} 34 ZERO_GRAD",
              "header": "Parameter /_0 {2} 33 ZERO_GRAD"}[fault]
    path.write_text(f"{header}\n{data}\n")
    with pytest.raises(ValueError):
        dynet_io.load_dynet_arrays(str(path))


def test_q_probe_rows_match_jax(tmp_path, full_net):
    params, net, _, pos = full_net
    js, scene = jax_cornell_box(), cornell_box(device="cpu")
    _close(probe_q_values(net, scene, pos), j_probe(params, js, pos))
    probe = tmp_path / "to_select.txt"
    probe.write_text("".join(f"{x:.6g} {y:.6g} {z:.6g} 0 1 0\n"
                             for x, y, z in pos[:8]))
    t_out, j_out = tmp_path / "t.txt", tmp_path / "j.txt"
    save_selected_q_values_nn(net, scene, str(probe), str(t_out))
    j_save_probe(params, js, str(probe), str(j_out))
    rows, j_rows = np.loadtxt(t_out), np.loadtxt(j_out)
    assert rows.shape == (8, 150)
    np.testing.assert_allclose(rows, j_rows, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(rows[:, 6:].sum(-1), 1.0, atol=1e-4)


def test_train_epoch_on_jax_permutation(full_net):
    """One distillation epoch (200 rows, batch 64: four Adam steps in
    JAX's permutation order) and the test MSE against JAX's."""
    js = jax_cornell_box()
    verts = js.vertices_flat
    params = dq_init(jax.random.PRNGKey(9), verts.shape[0], 36, (32, 48, 32))
    rng = np.random.default_rng(10)
    pos = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    tgt = rng.uniform(0, 2, (200, 36)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    j_p, _, j_loss = jdistill.train_epoch(
        key, params, optax.adam(1e-3).init(params), jnp.asarray(verts),
        jnp.asarray(pos), jnp.asarray(tgt), 64)
    net = dq_network_from_numpy(_layers(params))
    tv = torch.from_numpy(np.array(verts))
    loss = distill.train_epoch(
        net, adam_init(net.parameters()), tv, torch.from_numpy(pos),
        torch.from_numpy(tgt), 64,
        perm=torch.from_numpy(np.array(jax.random.permutation(key, 200))).long())
    _close(loss, j_loss, rtol=1e-5, atol=0)
    for p, jp in zip(net.parameters(), jax.tree_util.tree_leaves(j_p)):
        _close(p.detach(), jp, rtol=1e-4, atol=1e-6)
    _close(distill.eval_mse(net, tv, torch.from_numpy(pos),
                            torch.from_numpy(tgt)),
           jdistill.eval_mse(j_p, jnp.asarray(verts), jnp.asarray(pos),
                             jnp.asarray(tgt)), rtol=1e-4, atol=0)


def test_distillation_reduces_error(tmp_path):
    """distill() on a teacher network's Q table (the JAX test's set-up,
    through the files the reference trainer reads): test MSE falls."""
    js = jax_cornell_box()
    verts = A(js.vertices_flat)
    pos = np.random.default_rng(0).uniform(-1, 1, (256, 3)).astype(
        np.float32)
    teacher = dq_init(jax.random.PRNGKey(9), len(verts), 16, (8,))
    q = A(dq_apply_relative(teacher, jnp.asarray(verts), jnp.asarray(pos)))
    qt, vt = tmp_path / "radiance_map_data.txt", tmp_path / "vertices.txt"
    qt.write_text("16\n" + "".join(
        " ".join(str(v) for v in list(pos[i]) + list(q[i])) + "\n"
        for i in range(len(pos))))
    j_save_vertices(js, str(vt))
    net, history = distill.distill(str(qt), str(vt),
                                   config.TrainerConfig(epochs=8,
                                                        batch_size=64),
                                   hidden_sizes=(16,), device="cpu")
    errs = [h[2] for h in history]
    assert errs[-1] < errs[0] and all(np.isfinite(errs))
    assert net.layers[0].weight.shape == (16, 342)


def test_vertices_file_and_configs_match_jax(tmp_path):
    """vertices_flat, vertices.txt (byte-equal) and its reader, and the
    deep-learning and trainer configs' defaults."""
    js, scene = jax_cornell_box(), cornell_box(device="cpu")
    assert np.array_equal(scene.vertices_flat.numpy(), A(js.vertices_flat))
    assert scene.vertices_count == js.vertices_count == 342
    t_path, j_path = tmp_path / "t.txt", tmp_path / "j.txt"
    save_vertices_to_file(scene, str(t_path))
    j_save_vertices(js, str(j_path))
    assert t_path.read_bytes() == j_path.read_bytes()
    np.testing.assert_allclose(load_vertices_from_file(str(t_path)),
                               A(js.vertices_flat), rtol=1e-5)
    for port_cls, jax_cls in ((config.DeepLearningConfig,
                               jconfig.DeepLearningConfig),
                              (config.TrainerConfig, jconfig.TrainerConfig)):
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())
