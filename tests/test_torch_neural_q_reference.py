"""The deep-Q path tracer of rlrpt_tpu_torch held to the benchmark's plain
reference (benchmark/reference/neural_q.py) at the published widths
342-200-300-200-144 on the Cornell box, stage by stage on the CPU: the
forward (the port's factored first layer against the explicit 342-wide
encoding), the sampler and the TD targets on shared inputs, one
train_on_batches call against the hand-written backward and Adam, and
one wavefront iteration's captured stages, its closest hit included
(against the reference's brute-force sweep).

Every tolerance states why it holds, and each test shows the same
comparison failing for the reference computed in bfloat16, so none is
loose enough to pass a forward one precision lower."""

import math

import pytest
import torch

from benchmark.reference import neural_q as nqr
from benchmark.reference import pathtrace as pt
from benchmark.reference import scenes as ref_scenes
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import (DeepLearningConfig, RadianceVolumeConfig,
                                    RenderConfig)
from rlrpt_tpu_torch.deep import deep_wavefront as dw
from rlrpt_tpu_torch.deep import neural_q as nq
from rlrpt_tpu_torch.nn.adam import adam_init
from rlrpt_tpu_torch.ops import hemisphere as hs
from rlrpt_tpu_torch.scene import cornell_box

G = 12
SIZES = (342, 200, 300, 200, 144)
DL = DeepLearningConfig(batch_size=64)
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    scene = cornell_box(device="cpu")
    net, _ = nq.init_neural_q(11, scene, DL, G, device="cpu")
    tables = ref_scenes.cornell()
    verts = torch.as_tensor(nqr.vertices_flat(tables))
    assert torch.equal(verts, scene.vertices_flat)
    return scene, net, verts, tables


def _layers(net):
    return [(layer.weight.detach(), layer.bias.detach())
            for layer in net.layers]


def _points(scene, n, seed):
    """Points on the box's surfaces, as the forward sees them."""
    g = torch.Generator().manual_seed(seed)
    tri = torch.randint(0, scene.n_surfaces, (n,), generator=g)
    uv = torch.rand((n, 2), generator=g)
    uv = torch.where((uv.sum(-1) > 1.0)[:, None], 1.0 - uv, uv)
    v0 = scene.v0[tri]
    return (v0 + uv[:, :1] * (scene.v1[tri] - v0)
            + uv[:, 1:] * (scene.v2[tri] - v0)), scene.normal[tri]


def _rel_max(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def test_published_widths(setup):
    scene, net, _, _ = setup
    assert scene.vertices_count == SIZES[0]
    assert [tuple(layer.weight.shape) for layer in net.layers] == [
        (o, i) for i, o in zip(SIZES[:-1], SIZES[1:])]
    assert nqr.n_params(SIZES) == sum(p.numel() for p in net.parameters())
    assert nqr.n_params(SIZES) == 218_044


def test_forward_factored_against_explicit(setup):
    """rtol 1e-5: the factored first layer sums the same products in
    another order, so the two f32 forwards part by a few ulps of the
    largest Q (7.5e-7 seen); bfloat16 keeps 8 bits (6.8e-3 seen)."""
    scene, net, verts, _ = setup
    pos, _ = _points(scene, 512, 1)
    with torch.no_grad():
        got = net.forward_relative(scene.vertices_flat, pos)
    ref = nqr.q_values(_layers(net), verts, pos)
    assert float(ref.abs().max()) > 0
    assert _rel_max(got, ref) <= 1e-5
    assert _rel_max(nqr.q_values(_layers(net), verts, pos, BF16),
                    ref) > 1e-5


def test_sampler_on_shared_uniforms(setup):
    """The sectors equal and the pdfs within 1e-6 relative: the same
    products and cumulative sum in the same order; the direction within
    1e-5 (another tangent normalisation, the same Chiu map).  bfloat16's
    CDF draws other sectors."""
    scene, net, verts, _ = setup
    pos, normal = _points(scene, 2048, 2)
    with torch.no_grad():
        qs = net.forward_relative(scene.vertices_flat, pos)
    qs[:16] = 0.0                         # the uniform fallback
    u = torch.rand((2048, 5), generator=torch.Generator().manual_seed(3))
    eps = torch.full((2048,), 0.05)
    d, sector, pdf = nq.sample_q_directions_u(u, qs, normal, eps, G,
                                              1.0 / G ** 2)
    r_sector, r_pdf, r_d = nqr.sample(qs, u, normal, eps, G)
    assert torch.equal(sector, r_sector)
    torch.testing.assert_close(pdf, r_pdf, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(d, r_d, rtol=0.0, atol=1e-5)
    assert torch.equal(hs.sector_cos_thetas(G, "cpu"),
                       pt.sector_cos(G, "cpu", torch.float32))
    low = nqr.sample(qs, u, normal, eps, G, BF16)[0]
    assert not torch.equal(low, sector)


def test_td_targets(setup):
    """Equal bit for bit: the same max scan (Q_0 unweighted) and the same
    f32 products; bfloat16 parts by ~4e-3."""
    scene, net, _, tables = setup
    pos, _ = _points(scene, 1024, 4)
    with torch.no_grad():
        qs = net.forward_relative(scene.vertices_flat, pos)
    g = torch.Generator().manual_seed(5)
    tri = torch.randint(0, tables.n_triangles, (1024,), generator=g)
    lum = torch.as_tensor(tables.luminance, dtype=torch.float32)[tri]
    light = tri >= tables.n_surfaces
    surf = ~light & (torch.rand((1024,), generator=g) < 0.9)
    cos = hs.sector_cos_thetas(G, "cpu")
    got = torch.where(light, lum * DL.light_reward_scale,
                      torch.where(surf, lum * nq.bootstrap_max(qs, cos), 0.0))
    ref = nqr.td_targets(qs, lum, light, surf, DL.light_reward_scale, G)
    assert torch.equal(got, ref)
    low = nqr.td_targets(qs, lum, light, surf, DL.light_reward_scale, G, BF16)
    assert _rel_max(low, ref) > 1e-5


def _flat(net, opt):
    return dw.flat_state(net, opt)


def test_train_on_batches_against_the_hand_written_backward(setup):
    """Four minibatches of 64 (one with no weight, so no step) from a
    state three steps in: the weights' change within rtol 1e-5 of the
    reference's by norm.  Autograd through the factored layer and the
    hand-written backward through the explicit one sum the gradients in
    other orders (relative 1e-7 to 1e-6); Adam divides them by
    sqrt(nu), so the changes keep that relative size (8.5e-7 seen, the
    moments 3.0e-7).  In bfloat16 the change is off by 0.17."""
    scene, _, verts, _ = setup
    net, _ = nq.init_neural_q(11, scene, DL, G, device="cpu")
    opt = adam_init(net.parameters())
    pos, _ = _points(scene, 256, 6)
    g = torch.Generator().manual_seed(7)
    actions = torch.randint(0, G * G, (256,), generator=g)
    tds = torch.rand((256,), generator=g) * 3.0
    weights = (torch.rand((256,), generator=g) < 0.6).float()
    weights[64:128] = 0.0
    for _ in range(3):                       # moments from earlier steps
        nq.train_on_batches(net, opt, scene, pos[:64], actions[:64],
                            tds[:64], DL)
    flat0, count0 = _flat(net, opt)
    before = {"flat": flat0, "count": count0}
    nq.train_on_batches(net, opt, scene, pos, actions, tds, DL,
                        weights=weights)
    flat1, count1 = _flat(net, opt)
    kw = dict(batch=64, lr=DL.learning_rate, b1=DL.adam_b1, b2=DL.adam_b2,
              eps=DL.adam_eps)
    ref = nqr.train(before, SIZES, verts, pos, actions, tds, weights, **kw)
    n = nqr.n_params(SIZES)
    assert int(count1) == ref["count"] == int(count0) + 3
    change = ref["flat"][:n] - flat0[:n]
    gap = float((flat1[:n] - ref["flat"][:n]).norm() / change.norm())
    assert gap <= 1e-5
    moments = float((flat1[n:] - ref["flat"][n:]).norm()
                    / ref["flat"][n:].norm())
    assert moments <= 1e-5
    low = nqr.train(before, SIZES, verts, pos, actions, tds, weights,
                    ft=BF16, **kw)
    assert float((low["flat"][:n] - ref["flat"][:n]).norm()
                 / change.norm()) > 1e-5


@pytest.fixture(scope="module")
def frame(setup):
    """A 16x16 training frame (4 bounces, 64-row minibatches) with
    iteration 3 captured: (the capture, the image, the RenderConfig)."""
    scene = setup[0]
    net, opt = nq.init_neural_q(12, scene, DL, G, device="cpu")
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1,
                       max_ray_bounces=4)
    rl = RadianceVolumeConfig(grid_resolution=G)
    cap = dw.Capture(iterations=(3,), tail=True)
    dw.CAPTURE = cap
    try:
        img, _, _, _, _ = dw.render_frame_neural_q_wavefront(
            21, scene, Camera.create([0.0, 0.0, -3.0]), net, opt, 0.05, cfg,
            rl, DL, pix_mux=4)
    finally:
        dw.CAPTURE = None
    return cap, img, cfg


def test_a_wavefront_iteration_against_the_reference(setup, frame):
    """The captured iteration's stages held to the reference as the
    benchmark's check holds them (the tolerances above, rad within 1e-6
    relative: the same f32 products but the tangent's normalisation), and
    the frame's image to the reference's assembly of the flushes,
    exactly."""
    _, _, verts, tables = setup
    cap, img, cfg = frame
    rec = cap.records[3]
    st = rec["state"]
    _, light, surf = nqr.hit_masks(st.active, rec["t"], rec["tri"],
                                   tables.n_surfaces)
    assert bool(surf.any()) and bool(rec["pending"].any())
    n = nqr.n_params(SIZES)
    layers = nqr.layers_from_flat(rec["before"][0][:n], SIZES)
    q_ref = nqr.q_values(layers, verts, rec["qpos"][surf])
    assert _rel_max(rec["qs"][surf], q_ref) <= 1e-5
    normal, lum = rec["mrow"][:, 0:3], rec["mrow"][:, 10]
    sector, pdf, _ = nqr.sample(rec["qs"], rec["u"], normal, rec["eps"], G)
    assert torch.equal(sector[surf], rec["sector"][surf])
    td = nqr.td_targets(rec["qs"], lum, light, surf, DL.light_reward_scale,
                        G)
    assert torch.equal(td[st.active], rec["td"][st.active])
    before = {"flat": rec["before"][0], "count": rec["before"][1]}
    ref = nqr.train(before, SIZES, verts, st.prev_loc,
                    torch.clamp(st.action, min=0), rec["td"],
                    rec["pending"].float(), batch=DL.batch_size,
                    lr=DL.learning_rate, b1=DL.adam_b1, b2=DL.adam_b2,
                    eps=DL.adam_eps)
    after = rec["trained"][-1]
    assert int(after[1]) == ref["count"]
    change = ref["flat"][:n] - before["flat"][:n]
    assert float((after[0][:n] - ref["flat"][:n]).norm()
                 / change.norm()) <= 1e-5
    slot, srad, tp, surv = nqr.transport(
        st._asdict(), rec["t"], rec["tri"], rec["mrow"], sector, rec["u"],
        pdf, tables.n_surfaces, cfg.environment_light, cfg.max_ray_bounces,
        G)
    out = rec["out"]
    torch.testing.assert_close(out.slot_rad, slot, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(out.tp[surv], tp[surv], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(out.sample_rad[surv], srad[surv], rtol=1e-6,
                               atol=0.0)
    image = nqr.assemble(cap.flushes, cfg.n_pixels, cap.w0, 1)
    assert torch.equal(img.reshape(-1, 3), image)
    assert math.isclose(float(image.sum()), float(img.sum()))
    low = nqr.q_values(layers, verts, rec["qpos"][surf], BF16)
    assert _rel_max(low, q_ref) > 1e-5


def test_the_iterations_closest_hit_against_the_reference_sweep(setup,
                                                                 frame):
    """The captured iteration's closest hit (B4a's walk of the frame's
    tree) against the reference's brute-force sweep over its own tables:
    the same triangle and the same distance on every live ray, bit for
    bit, as the walk's and the sweep's Moller-Trumbore are one f32
    arithmetic; the point o + t d too; the material rows within 1e-6
    relative (the normals are normalised by two codes); the survivors'
    next origin and direction within 1e-6 (the direction's frame, as
    above).  The sweep in bfloat16 lands on other triangles."""
    _, _, _, tables = setup
    cap, _, cfg = frame
    rec = cap.records[3]
    st = rec["state"]
    act = st.active
    tris, mat = tables.packed("cpu")

    def sweep(ft):
        o, d = st.o.to(ft), st.d.to(ft)
        t, tri = pt.closest_hit(o[:, 0], o[:, 1], o[:, 2], d[:, 0],
                                d[:, 1], d[:, 2], tris.to(ft))[:2]
        return t, tri, o + t[:, None] * d

    t, tri, qpos = sweep(torch.float32)
    hit = act & (t < nqr.INF_CUT)
    assert bool(hit.any())
    assert torch.equal(rec["t"] < nqr.INF_CUT, t < nqr.INF_CUT)
    assert torch.equal(rec["tri"][hit].long(), tri[hit])
    assert torch.equal(rec["t"][hit], t[hit])
    surf = hit & (tri < tables.n_surfaces)
    assert torch.equal(rec["qpos"][surf], qpos[surf])
    torch.testing.assert_close(rec["mrow"][hit][:, :11], mat[tri[hit]][:, :11],
                               rtol=1e-6, atol=1e-7)
    surv = surf & (st.bounce + 1 < cfg.max_ray_bounces)
    assert bool(surv.any())
    new_d = nqr.direction(rec["sector"], rec["u"][:, 3:5], mat[tri][:, 0:3],
                          G)
    out = rec["out"]
    torch.testing.assert_close(out.d[surv], new_d[surv], rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(out.o[surv], (qpos + cfg.eps * new_d)[surv],
                               rtol=1e-6, atol=1e-7)
    t_low, tri_low, _ = sweep(BF16)
    assert bool((tri_low[hit] != tri[hit]).any()) or _rel_max(
        t_low[hit], t[hit]) > 1e-6
