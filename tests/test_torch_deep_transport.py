"""The deep-Q wavefront's sample-and-transport kernel
(ops/deep_transport.py, csrc/deep_transport.cu).

On the CPU: the wrapper runs the plain twin, bit for bit; it raises on an
input the kernel does not take; a traced CPU frame counts no launch; the
benchmark's reader ``transport_kernel_pct.deep`` reads the counts.  On the
card (``-m chip``): the kernel against the twin run on the card, from the
same state, hit, Q rows and uniforms, at the deep cell's widest and
narrowest phases, with Russian roulette, on a shard of the image and on a
4x4 sector grid.  The kernel adds in the order of torch's reductions and
scan on the card, so a lane's sector is the twin's, and each lane whose
sector agrees is the twin's bit for bit, every field; a sector may flip
only where that order departs from torch's (a u1 an ulp from a step of the
CDF), so the sectors have to agree on 99.99% of the surface lanes (all of
them on the H100 with torch 2.11).  The four statistics are sums of whole
numbers and agree exactly.
"""

import dataclasses
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import (DeepLearningConfig, RadianceVolumeConfig,
                                    RenderConfig)
from rlrpt_tpu_torch.deep import deep_wavefront as dw
from rlrpt_tpu_torch.deep import neural_q as nq
from rlrpt_tpu_torch.ops import deep_transport as dt
from rlrpt_tpu_torch.ops.hemisphere import sector_cos_thetas
from rlrpt_tpu_torch.scene import cornell_box
from rlrpt_tpu_torch.utils import profiling
from _torch_parity import card  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CAM = Camera.create([0.1, 0.2, -3.0], yaw_y=0.3, yaw_x=-0.2)
N_SURFACES, N_TRIS = 30, 34


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.RECORDER.reset()
    yield
    profiling.RECORDER.reset()


def _case(wp, gr, *, size=(64, 64), pix_mux=4, spp=2, pix_lo=0,
          n_local=None, rr=False, train=True, seed=0):
    """A step's inputs, made on the CPU: (state, t, tri, mrow, qpos, qs,
    u, u_rr, u_pix, cos), stats and the Frame.  ``wp`` lanes of a frame of
    ``size`` pixels; lanes live, dead, missing, on a light, on a surface,
    at the bounce cap and at each stage of their pixels' samples."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=g)  # noqa: E731
    ints = lambda hi, n: torch.randint(0, hi, (n,), generator=g)  # noqa: E731
    cfg = RenderConfig(width=size[0], height=size[1], samples_per_pixel=spp,
                       max_ray_bounces=6, russian_roulette=rr,
                       environment_light=0.25)
    n_pix = cfg.n_pixels
    n_local = n_pix - pix_lo if n_local is None else n_local
    w0 = -(-n_local // pix_mux)
    s = gr * gr
    fr = dt.Frame(n_surfaces=N_SURFACES, w0=w0, n_pix=n_pix,
                  pix_end=pix_lo + n_local, pix_mux=pix_mux, spp=spp,
                  camera=CAM, cfg=cfg, gr=gr,
                  grid_rho=RadianceVolumeConfig(grid_resolution=gr).grid_rho,
                  epsilon=(0.3, 1e-3, 0.05) if train else None)
    kmx = ints(pix_mux, wp)
    pixel = pix_lo + ints(w0, wp) + kmx * w0
    active = (rand(wp) < 0.85) & (pixel < pix_lo + n_local)
    state = dw._State(
        o=rand(wp, 3) * 2 - 1, d=torch.nn.functional.normalize(
            rand(wp, 3) * 2 - 1, dim=-1),
        tp=rand(wp, 3), pixel=pixel, kmx=kmx,
        bounce=ints(cfg.max_ray_bounces, wp).int(),
        remaining=ints(spp, wp).int(), sord=ints(4 * spp, wp).int(),
        active=active, sample_rad=rand(wp, 3) * 0.1,
        slot_rad=rand(wp, pix_mux, 3),
        prev_loc=rand(wp, 3), action=ints(s, wp) - (rand(wp) < 0.3).long())
    tri = ints(N_TRIS, wp).int()
    t = torch.where(rand(wp) < 0.2, 3.0e38, rand(wp) * 3.0)
    t = torch.where(active, t, 3.0e38)
    hit = t < 3.0e38
    # unit normals: a third of them on an axis, as the Cornell box's
    axis = torch.eye(3)[ints(3, wp)] * torch.where(rand(wp, 1) < 0.5, -1.0,
                                                   1.0)
    normal = torch.nn.functional.normalize(rand(wp, 3) * 2 - 1, dim=-1)
    normal = torch.where(rand(wp, 1) < 0.33, axis, normal)
    mrow = torch.zeros((wp, 16))
    mrow[:, 0:3] = normal
    mrow[:, 3:6] = rand(wp, 3)
    mrow[:, 6:9] = torch.where((tri >= N_SURFACES)[:, None], rand(wp, 3) * 5,
                               0.0)
    mrow[:, 10] = rand(wp)
    mrow = torch.where(hit[:, None], mrow, 0.0)
    surface = hit & (tri < N_SURFACES)
    qpos = torch.where(surface[:, None], state.o + t[:, None] * state.d, 0.0)
    qs = torch.relu(rand(wp, s) * 4 - 1) * rand(wp, 1) * 3
    qs[rand(wp) < 0.05] = 0.0               # an all-zero row: uniform
    inputs = (state, t, tri, mrow, qpos, qs, rand(wp, 5),
              rand(wp) if rr else None, rand(wp, 2),
              sector_cos_thetas(gr, "cpu").clone())
    return inputs, fr


def _stats(device):
    z = lambda dtype: torch.zeros((), dtype=dtype, device=device)  # noqa: E731
    return {"path_sum": z(torch.float64), "light_path_sum": z(torch.float64),
            "zclp": z(torch.int64), "light_hits": z(torch.int64)}


def _to(inputs, device):
    out = []
    for a in inputs:
        if isinstance(a, tuple):
            a = type(a)(*(x.to(device) for x in a))
        elif a is not None:
            a = a.to(device)
        out.append(a)
    return out


@pytest.mark.parametrize("kw", [dict(), dict(train=False),
                                dict(rr=True, seed=1),
                                dict(pix_lo=1000, n_local=2000, seed=2),
                                dict(spp=1, pix_mux=1, seed=3)])
def test_the_wrapper_runs_the_twin_on_the_cpu(kw):
    inputs, fr = _case(300, 6, **kw)
    a_stats, b_stats = _stats("cpu"), _stats("cpu")
    launches = dt.KERNEL.launches
    got = dt.sample_transport(*inputs, a_stats, fr)
    ref = dt.sample_transport_plain(*inputs, b_stats, fr)
    assert dt.KERNEL.launches == launches
    for x, y in zip(got[0] + got[1:], ref[0] + ref[1:]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for k in dt.STATS:
        assert torch.equal(a_stats[k], b_stats[k]), k
    assert int(a_stats["light_hits"]) > 0 and float(a_stats["path_sum"]) > 0
    # the step banks finished samples
    assert not torch.equal(got[0].slot_rad, inputs[0].slot_rad)


def _bad(name):
    """The CPU case with one input made wrong, and the message expected."""
    inputs, fr = _case(40, 4, rr=name == "u_rr missing")
    state, t, tri, mrow, qpos, qs = inputs[:6]
    u_rr = inputs[7]
    stats = _stats("cpu")
    if name == "dtype":
        qs, msg = qs.double(), "qs must be torch.float32"
    elif name == "shape":
        qpos, msg = qpos[:, :2].contiguous(), "qpos must be"
    elif name == "sectors":
        qs, msg = torch.cat([qs, qs[:, :1]], 1), "qs must be"
    elif name == "too many sectors":
        fr = dataclasses.replace(fr, gr=22)
        msg = "at most 441 sectors"
    elif name == "device":
        t, msg = t.to("meta"), "t must be on the state's device"
    elif name == "contiguous":
        mrow, msg = mrow.t().contiguous().t(), "mrow must be contiguous"
    elif name == "state field":
        state = state._replace(sord=state.sord.long())
        msg = "sord must be torch.int32"
    elif name == "stats":
        stats["zclp"], msg = stats["zclp"].int(), "zclp must be"
    elif name == "u_rr missing":
        u_rr, msg = None, "u_rr is missing"
    else:
        u_rr, msg = t.clone(), "u_rr is for Russian roulette"
    return (state, t, tri, mrow, qpos, qs, inputs[6], u_rr, inputs[8],
            inputs[9], stats, fr), msg


@pytest.mark.parametrize("name", ["dtype", "shape", "sectors",
                                  "too many sectors", "device", "contiguous",
                                  "state field", "stats", "u_rr missing",
                                  "u_rr unwanted"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(name):
    args, msg = _bad(name)
    with pytest.raises(ValueError, match=msg):
        dt.sample_transport(*args)


CFG = RenderConfig(width=16, height=16, samples_per_pixel=1,
                   max_ray_bounces=5)
DL = DeepLearningConfig(batch_size=32, hidden_sizes=(16, 24, 16))
RL = RadianceVolumeConfig(grid_resolution=6)


def _frame(device, cfg=CFG, dl=DL, rl=RL):
    scene = cornell_box(device=device)
    net, opt = nq.init_neural_q(3, scene, dl, rl.grid_resolution,
                                device=device)
    return dw.render_frame_neural_q_wavefront(
        10, scene, Camera.create([0.0, 0.0, -3.0]), net, opt, 0.05, cfg, rl,
        dl, pix_mux=4)


def test_a_cpu_frame_counts_its_steps_and_no_launch():
    with profile(activities=[ProfilerActivity.CPU]):
        _frame("cpu")
    rec = profiling.RECORDER
    assert rec.counts["deep_wavefront.steps"] > 0
    assert rec.counts["deep_wavefront.transport_launches"] == 0
    assert (rec.calls["trace_frame_deep_wavefront.transport"]
            == rec.counts["deep_wavefront.steps"])


@pytest.mark.parametrize("counts,value", [
    ({"deep_wavefront.steps": 360,
      "deep_wavefront.transport_launches": 360}, 100.0),
    ({"deep_wavefront.steps": 360,
      "deep_wavefront.transport_launches": 90}, 25.0),
    ({"deep_wavefront.steps": 360}, None),     # a program without the kernel
    ({}, None)])
def test_transport_kernel_pct_reads_the_launch_counts(counts, value):
    read = harness.load_module(
        ROOT / "benchmark" / "metrics" / "transport_kernel_pct.deep.py",
        "metric_transport_kernel_pct_deep").read
    rec = profiling.RECORDER
    rec.calls["trace_frame_deep_wavefront.pack"] = 2
    rec.counts.update(counts)
    run = types.SimpleNamespace(
        traffic={"loop": "progressive"}, traced_answers=2,
        extra={"deep": {}}, trace_summary={"window_s": 4.0, "busy_s": 3.0})
    assert read(run) == value
    assert read(types.SimpleNamespace(**dict(vars(run), extra={}))) is None
    assert read(types.SimpleNamespace(
        **dict(vars(run), trace_summary=None))) is None


def _ulps(a, b):
    """|a - b| in units in the last place of f32 (0 where a == b)."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return torch.where(a == b, 0, (ia - ib).abs())


CARD_CASES = {
    # the deep cell's widest phase: 720x720 at 4 pixels a slot, 12x12
    "widest": dict(wp=129600, gr=12, size=(720, 720)),
    # its narrowest, a frozen net (the pretrained wavefront)
    "narrowest frozen": dict(wp=2025, gr=12, size=(720, 720), train=False,
                             seed=1),
    "roulette": dict(wp=4096, gr=12, rr=True, seed=2),
    "shard": dict(wp=3000, gr=12, size=(128, 128), pix_lo=5000,
                  n_local=6000, pix_mux=2, seed=3),
    "16 sectors": dict(wp=8192, gr=4, size=(128, 128), seed=4),
    # 720x720 at 2 pixels a slot: torch's scan takes 1,024 columns at a time
    "two pixels a slot": dict(wp=259200, gr=12, size=(720, 720), pix_mux=2,
                              seed=5),
}


@pytest.mark.chip
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_the_kernel_is_the_twin_on_the_card(card, name):
    kw = dict(CARD_CASES[name])
    inputs, fr = _case(kw.pop("wp"), kw.pop("gr"), **kw)
    inputs = _to(inputs, card)
    k_stats, t_stats = _stats(card), _stats(card)
    launches = dt.KERNEL.launches
    got = dt.sample_transport(*inputs, k_stats, fr)
    ref = dt.sample_transport_plain(*inputs, t_stats, fr)
    torch.cuda.synchronize()
    assert dt.KERNEL.launches == launches + 1
    state, t, tri = inputs[:3]
    surf = state.active & (t < 1.0e38) & (tri < N_SURFACES)
    same = got[1] == ref[1]
    agree = float(same[surf].double().mean())
    ulps = {}
    for name_, x, y in zip(dt.SLOT_FIELDS + ("sector", "pdf"),
                           got[0] + got[1:], ref[0] + ref[1:]):
        assert x.dtype == y.dtype and x.shape == y.shape, name_
        x, y = x[same], y[same]
        if x.dtype == torch.float32:
            ulps[name_] = int(_ulps(x, y).max()) if x.numel() else 0
        else:
            assert torch.equal(x, y), name_
    print(f"{name}: sectors agree on {agree:.6f} of "
          f"{int(surf.sum())} surface lanes; most ulps apart {ulps}")
    assert agree >= 0.9999
    assert max(ulps.values()) == 0, ulps
    for k in dt.STATS:
        assert torch.equal(k_stats[k], t_stats[k]), k
    assert int(k_stats["light_hits"]) > 0


@pytest.mark.chip
def test_a_traced_card_frame_launches_the_kernel_every_step(card):
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=1,
                       max_ray_bounces=8)
    _frame(card, cfg)                    # every first call, unrecorded
    torch.cuda.synchronize()
    profiling.RECORDER.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _frame(card, cfg)
        torch.cuda.synchronize()
    rec = profiling.RECORDER
    assert rec.counts["deep_wavefront.steps"] > 0
    assert (rec.counts["deep_wavefront.transport_launches"]
            == rec.counts["deep_wavefront.steps"])
