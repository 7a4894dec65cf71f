"""The fine-map SARSA wavefront's sector-draw-and-transport kernel
(ops/sarsa_transport.py, csrc/sarsa_transport.cu).

On the CPU: the wrapper runs the plain twins, and they are the frame's
former torch code of the two stages (``_former_stages`` below, kept as it
was) bit for bit, for every sampler, frame mode, row dtype and roulette
setting; the wrapper raises on an input the kernel does not take; a traced
CPU frame counts no launch; the benchmark's reader
``transport_kernel_pct.sarsa`` reads the counts.  On the card (``-m
chip``): the kernel against the twin run on the card, from the same state,
hit, rows and uniforms, at the fine-map cell's four phase widths, at a
width that is no multiple of the block, with no live lane, on f32 and bf16
rows, in the hit's and the volume's frame, with Russian roulette, and the
transport-only entry of the two-level sampler: every output bit for bit,
the sector counted over all S entries as the twin counts them.
"""

import collections
import dataclasses
import math
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.integrators import sarsa_wavefront as sw
from rlrpt_tpu_torch.integrators.wavefront import primary_dirs_u
from rlrpt_tpu_torch.ops import sarsa_transport as st
from rlrpt_tpu_torch.ops.linalg import make_frame
from rlrpt_tpu_torch.radiance.grid_bucket import build_volume_class_table
from rlrpt_tpu_torch.radiance.volumes import (build_radiance_volumes,
                                              sample_from_cdf_rows_u)
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
          n_local=None, rr=False, n_vol=60, bf16=False, volume=False,
          live=0.85, seed=0):
    """A step's inputs, made on the CPU: a dict of (state, hit, mrow,
    cdfplus, frames, r, u, u_rr, u_pix, and the two-level sampler's
    sector, pdf, new_d), the stats and the Frame.  ``wp`` lanes of a frame
    of ``size`` pixels; lanes live, dead, missing, on a light, on a
    surface, at the bounce cap and at each stage of their pixels'
    samples; ``n_vol`` volumes whose CDF rows come from torch's scan."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=g)  # noqa: E731
    ints = lambda hi, n: torch.randint(0, hi, (n,), generator=g)  # noqa: E731
    cfg = RenderConfig(width=size[0], height=size[1], samples_per_pixel=spp,
                       max_ray_bounces=6, russian_roulette=rr,
                       rr_start_bounce=2, environment_light=0.25)
    n_pix = cfg.n_pixels
    n_local = n_pix - pix_lo if n_local is None else n_local
    w0 = -(-n_local // pix_mux)
    s = gr * gr
    fr = st.Frame(w0=w0, n_pix=n_pix, pix_end=pix_lo + n_local,
                  pix_mux=pix_mux, spp=spp, camera=CAM, cfg=cfg, gr=gr,
                  grid_rho=RadianceVolumeConfig(grid_resolution=gr).grid_rho)
    kmx = ints(pix_mux, wp)
    pixel = pix_lo + ints(w0, wp) + kmx * w0
    active = (rand(wp) < live) & (pixel < pix_lo + n_local)
    unit = lambda n: torch.nn.functional.normalize(  # noqa: E731
        rand(n, 3) * 2 - 1, dim=-1)
    state = sw._State(
        o=rand(wp, 3) * 2 - 1, d=unit(wp), tp=rand(wp, 3), pixel=pixel,
        kmx=kmx, bounce=ints(cfg.max_ray_bounces, wp).int(),
        remaining=ints(spp, wp).int(), active=active,
        sample_rad=rand(wp, 3) * 0.1, slot_rad=rand(wp, pix_mux, 3),
        cur_vol=ints(n_vol, wp), cur_sector=ints(s, wp) - (rand(wp) < 0.3)
        .long(), cur_brdf=rand(wp))
    tri = ints(N_TRIS, wp)
    t = torch.where(rand(wp) < 0.2, 3.0e38, rand(wp) * 3.0)
    t = torch.where(active, t, 3.0e38)
    missed = active & (t >= sw.INF_CUT)
    light = active & ~missed & (tri >= N_SURFACES)
    surface = active & ~missed & (tri < N_SURFACES)
    # unit normals: a third of them on an axis, as the Cornell box's
    axis = torch.eye(3)[ints(3, wp)] * torch.where(rand(wp, 1) < 0.5, -1.0,
                                                   1.0)
    mrow = torch.zeros((wp, 16))
    mrow[:, 0:3] = torch.where(rand(wp, 1) < 0.33, axis, unit(wp))
    mrow[:, 3:6] = rand(wp, 3)
    mrow[:, 6:9] = torch.where((tri >= N_SURFACES)[:, None], rand(wp, 3) * 5,
                               0.0)
    mrow[:, 10] = rand(wp)
    mrow = torch.where((t < 3.0e38)[:, None], mrow, 0.0)
    next_vol = ints(n_vol, wp)
    hit = st.Hit(missed, light, surface, state.o + t[:, None] * state.d,
                 mrow[:, 0:3], mrow[:, 3:6], mrow[:, 6:9], mrow[:, 10],
                 next_vol)
    # the rows as rebuild_cdf makes them, some uniform, some with empty
    # sectors, then the irradiance column
    w = torch.relu(rand(n_vol, s) * 4 - 1) * rand(n_vol, 1)
    w[rand(n_vol) < 0.1] = 1.0
    cdf = torch.cumsum(w / (1e-10 + w.sum(-1, keepdim=True)), dim=-1)
    cdfplus = torch.cat([cdf, rand(n_vol, 1)], dim=1)
    if bf16:
        cdfplus = cdfplus.to(torch.bfloat16)
    normals = torch.where(rand(n_vol, 1) < 0.5,
                          torch.eye(3)[ints(3, n_vol)], unit(n_vol))
    new_d = unit(wp)
    inputs = dict(state=state, hit=hit, mrow=mrow, cdfplus=cdfplus,
                  frames=make_frame(normals) if volume else None,
                  r=rand(wp, 1), u=rand(wp, 2), u_rr=rand(wp) if rr else None,
                  u_pix=rand(wp, 2), sector=ints(s, wp),
                  pdf=rand(wp) * 0.3, new_d=new_d)
    return inputs, fr


def _stats(device="cpu"):
    return {"path_sum": torch.tensor(17.0, dtype=torch.float64,
                                     device=device),
            "zclp": torch.tensor(3, dtype=torch.int64, device=device)}


def _former_stages(c, x, fr, sampler):
    """The frame's ``.sample`` and ``.transport`` stages as they were
    before the kernel took them over, on the step's inputs ``x``: (the
    new state, sector, pdf, path_sum, zclp) from the stats ``_stats``
    starts with."""
    cfg, device = fr.cfg, c.o.device
    path_sum, zclp = _stats(device).values()
    act = c.active
    mrow = x["mrow"]
    missed, hit_light, hit_surface = x["hit"][:3]
    hit_pos, next_vol = x["hit"].pos, x["hit"].next_vol
    normal, diffuse3 = mrow[:, 0:3], mrow[:, 3:6]
    emission3, lum = mrow[:, 6:9], mrow[:, 10]
    vrow = x["cdfplus"][next_vol].float()
    ksel_base = torch.arange(fr.pix_mux, device=device)
    cam_o = torch.tensor(fr.camera.position, dtype=torch.float32,
                         device=device)
    w0, n_pix, pix_end, pix_mux, spp = (fr.w0, fr.n_pix, fr.pix_end,
                                        fr.pix_mux, fr.spp)
    u_rr, u_pix = x["u_rr"], x["u_pix"]

    # .sample
    frm = make_frame(normal) if x["frames"] is None else \
        x["frames"][next_vol]
    if sampler == "hier":
        new_d, sector, pdf = x["new_d"], x["sector"], x["pdf"]
    else:
        new_d, sector, pdf = sample_from_cdf_rows_u(
            x["r"], x["u"], vrow[:, :-1], frm, fr.grid_rho, fr.gr)

    # .transport
    sample_rad = (c.sample_rad
                  + torch.where(missed[:, None],
                                c.tp * cfg.environment_light, 0.0)
                  + torch.where(hit_light[:, None], c.tp * emission3,
                                0.0))
    cos_theta = torch.sum(normal * new_d, dim=-1)
    pdf_safe = torch.clamp(pdf, min=1e-12)
    exhausted = hit_surface & (c.bounce + 1 >= cfg.max_ray_bounces)
    survive = hit_surface & ~exhausted
    tp = torch.where(survive[:, None],
                     c.tp * (diffuse3 / math.pi)
                     * (cos_theta / pdf_safe)[:, None], c.tp)
    rr_killed = torch.zeros_like(survive)
    if cfg.russian_roulette:
        p = torch.clamp(tp.max(dim=-1).values, cfg.rr_min_prob, 1.0)
        do_rr = survive & (c.bounce + 1 >= cfg.rr_start_bounce)
        rr_killed = do_rr & (u_rr >= p)
        tp = torch.where((do_rr & ~rr_killed)[:, None],
                         tp / p[:, None], tp)
        survive = survive & ~rr_killed

    o = torch.where(survive[:, None], hit_pos + cfg.eps * new_d, c.o)
    d = torch.where(survive[:, None], new_d, c.d)
    bounce = torch.where(survive, c.bounce + 1, c.bounce)
    cur_vol = torch.where(survive, next_vol, c.cur_vol)
    cur_sector = torch.where(survive, sector, -1)
    cur_brdf = torch.where(survive, lum / math.pi, c.cur_brdf)

    fin = (bounce + 1).double()
    path_sum = (path_sum
                + torch.where(missed | hit_light | rr_killed, fin,
                              0.0).sum()
                + exhausted.sum().double() * cfg.max_ray_bounces)
    finished = act & ~survive
    zero = finished & (sample_rad.mean(-1)
                       < cfg.throughput_threshold)
    zclp = zclp + zero.sum()

    slot_rad = c.slot_rad + (
        (ksel_base == c.kmx[:, None])[:, :, None]
        * torch.where(finished[:, None], sample_rad, 0.0)[:, None, :])

    next_pix = c.pixel + w0
    step_k = (finished & (c.remaining <= 0) & (c.kmx + 1 < pix_mux)
              & (next_pix < n_pix) & (next_pix < pix_end))
    pixel = torch.where(step_k, next_pix, c.pixel)
    kmx = torch.where(step_k, c.kmx + 1, c.kmx)
    remaining = torch.where(step_k, spp, c.remaining)
    regen = finished & (remaining > 0)
    rd = primary_dirs_u(u_pix, pixel, fr.camera, cfg)
    out = sw._State(
        o=torch.where(regen[:, None], cam_o, o),
        d=torch.where(regen[:, None], rd, d),
        tp=torch.where(regen[:, None], 1.0, tp), pixel=pixel,
        kmx=kmx, bounce=torch.where(regen, 0, bounce),
        remaining=torch.where(regen, remaining - 1, remaining),
        active=survive | regen,
        sample_rad=torch.where(regen[:, None], 0.0, sample_rad),
        slot_rad=slot_rad, cur_vol=cur_vol,
        cur_sector=torch.where(regen, -1, cur_sector),
        cur_brdf=cur_brdf)
    return out, sector, pdf, path_sum, zclp


def _run(entry, x, stats, fr, sampler):
    """``entry`` (the wrapper or a twin) on the step ``x``: (the new
    state, sector, pdf)."""
    if sampler == "hier":
        out = entry[1](x["state"], x["hit"], x["sector"], x["pdf"],
                       x["new_d"], x["u_rr"], x["u_pix"], stats, fr)
        return out, x["sector"], x["pdf"]
    return entry[0](x["state"], x["hit"], x["cdfplus"], x["frames"], x["r"],
                    x["u"], x["u_rr"], x["u_pix"], stats, fr)


WRAPPER = (st.sample_transport, st.transport)
TWIN = (st.sample_transport_plain, st.transport_plain)


@pytest.mark.parametrize("sampler,kw", [
    ("row", dict()), ("row", dict(gr=12, seed=1)),
    ("row", dict(bf16=True, seed=2)), ("row", dict(volume=True, seed=3)),
    ("row", dict(rr=True, seed=4)),
    ("row", dict(pix_lo=1000, n_local=2000, seed=5)),
    ("row", dict(spp=1, pix_mux=1, seed=6)),
    ("hier", dict(seed=7)), ("hier", dict(rr=True, volume=True, seed=8))])
def test_the_wrapper_runs_the_frames_former_stages_on_the_cpu(sampler, kw):
    x, fr = _case(300, kw.pop("gr", 6), **kw)
    ref = _former_stages(x["state"], x, fr, sampler)
    launches = st.KERNEL.launches
    for entry in (WRAPPER, TWIN):
        stats = _stats()
        got = _run(entry, x, stats, fr, sampler)
        assert st.KERNEL.launches == launches
        for name, a, b in zip(st.SLOT_FIELDS + ("sector", "pdf"),
                              got[0] + got[1:], ref[0] + ref[1:3]):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        assert torch.equal(stats["path_sum"], ref[3])
        assert torch.equal(stats["zclp"], ref[4])
        assert float(stats["path_sum"]) > 17
        # the step banks finished samples
        assert not torch.equal(got[0].slot_rad, x["state"].slot_rad)
    assert fr.checked == {300}


def test_the_checks_run_once_a_width():
    x, fr = _case(40, 4)
    _run(WRAPPER, x, _stats(), fr, "row")
    assert fr.checked == {40}
    # a checked width is not checked again: the frame hands each step of a
    # phase tensors of the same kinds; a new frame checks
    x["r"] = x["r"].double()
    _run(WRAPPER, x, _stats(), fr, "row")
    with pytest.raises(ValueError, match="r must be torch.float32"):
        _run(WRAPPER, x, _stats(), dataclasses.replace(fr, checked=set()),
             "row")


def _bad(name):
    """A CPU case with one input made wrong, and the message expected."""
    x, fr = _case(40, 4, rr=name == "u_rr missing")
    stats = _stats()
    sampler = "row"
    hit = x["hit"]
    if name == "dtype":
        x["u"], msg = x["u"].double(), "u must be torch.float32"
    elif name == "shape":
        x["u_pix"], msg = x["u_pix"][:, :1].contiguous(), "u_pix must be"
    elif name == "rows":
        x["cdfplus"] = x["cdfplus"][:, :-1].contiguous()
        msg = r"cdfplus must be \(V, 17\)"
    elif name == "rows dtype":
        x["cdfplus"] = x["cdfplus"].double()
        msg = "cdfplus must be torch.float32 or torch.bfloat16"
    elif name == "frames":
        x["frames"], msg = torch.zeros((5, 3, 3)), "frames must be"
    elif name == "device":
        x["hit"], msg = hit._replace(pos=hit.pos.to("meta")), \
            "pos must be on the state's device"
    elif name == "other device":
        x["state"] = type(x["state"])(*(a.to("meta") for a in x["state"]))
        msg = "no kernel for device meta"
    elif name == "alignment":
        x["u_pix"] = torch.rand(81)[1:].view(40, 2)
        msg = "u_pix must be 8-byte aligned"
    elif name == "contiguous":
        x["u"], msg = x["u"].t().contiguous().t(), "u must be contiguous"
    elif name == "material stride":
        x["hit"] = hit._replace(diffuse=hit.diffuse.t().contiguous().t())
        msg = "diffuse must have its last stride 1"
    elif name == "material dtype":
        x["hit"], msg = hit._replace(lum=hit.lum.double()), "lum must be"
    elif name == "state field":
        x["state"] = x["state"]._replace(bounce=x["state"].bounce.long())
        msg = "bounce must be torch.int32"
    elif name == "state fields":
        other = collections.namedtuple("Other", st.SLOT_FIELDS[:-1]
                                       + ("brdf",))
        x["state"] = other(*x["state"])
        msg = "the slot state's fields must be"
    elif name == "stats":
        stats["zclp"], msg = stats["zclp"].int(), "zclp must be"
    elif name == "u_rr missing":
        x["u_rr"], msg = None, "u_rr is missing"
    elif name == "u_rr unwanted":
        x["u_rr"], msg = torch.rand(40), "u_rr is for Russian roulette"
    elif name == "hier pdf":
        sampler, msg = "hier", "pdf must be torch.float32"
        x["pdf"] = x["pdf"].double()
    return x, stats, fr, sampler, msg


@pytest.mark.parametrize("name", [
    "dtype", "shape", "rows", "rows dtype", "frames", "device",
    "other device", "alignment", "contiguous", "material stride",
    "material dtype", "state field", "state fields", "stats",
    "u_rr missing", "u_rr unwanted", "hier pdf"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(name):
    x, stats, fr, sampler, msg = _bad(name)
    with pytest.raises(ValueError, match=msg):
        _run(WRAPPER, x, stats, fr, sampler)
    assert not fr.checked


CFG = RenderConfig(width=16, height=16, samples_per_pixel=2,
                   max_ray_bounces=5)
RL = RadianceVolumeConfig(area_per_sample=0.05)


def _frame(device, cfg=CFG, sampler="row"):
    scene = cornell_box(device=device)
    vols = build_radiance_volumes(scene, RL)
    table = build_volume_class_table(vols, scene)
    return sw.render_frame_sarsa_wavefront(
        10, scene, Camera.create([0.0, 0.0, -3.0]), vols, table, cfg, RL,
        pix_mux=4, sampler=sampler, min_drain_w=16)


@pytest.mark.parametrize("sampler", ["row", "hier"])
def test_a_cpu_frame_counts_its_steps_and_no_launch(sampler):
    with profile(activities=[ProfilerActivity.CPU]):
        _frame("cpu", sampler=sampler)
    rec = profiling.RECORDER
    assert rec.counts["sarsa_wavefront.steps"] > 0
    assert rec.counts["sarsa_wavefront.transport_launches"] == 0
    for stage in ("sample", "transport"):
        assert (rec.calls[f"trace_frame_sarsa_wavefront.{stage}"]
                == rec.counts["sarsa_wavefront.steps"])


@pytest.mark.parametrize("counts,value", [
    ({"sarsa_wavefront.steps": 540,
      "sarsa_wavefront.transport_launches": 540}, 100.0),
    ({"sarsa_wavefront.steps": 540,
      "sarsa_wavefront.transport_launches": 135}, 25.0),
    ({"sarsa_wavefront.steps": 540}, None),     # a program without the kernel
    ({}, None)])
def test_transport_kernel_pct_reads_the_launch_counts(counts, value):
    read = harness.load_module(
        ROOT / "benchmark" / "metrics" / "transport_kernel_pct.sarsa.py",
        "metric_transport_kernel_pct_sarsa").read
    rec = profiling.RECORDER
    rec.calls["trace_frame_sarsa_wavefront.pack"] = 2
    rec.counts.update(counts)
    run = types.SimpleNamespace(
        traffic={"loop": "progressive"}, traced_answers=2,
        extra={"sarsa": {}}, trace_summary={"window_s": 4.0, "busy_s": 0.4})
    assert read(run) == value
    assert read(types.SimpleNamespace(**dict(vars(run), extra={}))) is None
    assert read(types.SimpleNamespace(
        **dict(vars(run), trace_summary=None))) is None


def _to(x, device):
    out = {}
    for k, a in x.items():
        if isinstance(a, tuple):
            a = type(a)(*(t.to(device) for t in a))
        elif a is not None:
            a = a.to(device)
        out[k] = a
    # the hit's material fields as the frame hands them: views of B4a's row
    mrow = out["mrow"]
    out["hit"] = out["hit"]._replace(normal=mrow[:, 0:3],
                                     diffuse=mrow[:, 3:6],
                                     emission=mrow[:, 6:9], lum=mrow[:, 10])
    return out


# the fine-map cell's phases: 720x720 at 4 pixels a slot, 12x12 sectors,
# 24,526 volumes
CELL = dict(gr=12, size=(720, 720), n_vol=24526)
CARD_CASES = {
    "129600 lanes": dict(wp=129600, **CELL),
    "32400 lanes, bf16 rows": dict(wp=32400, bf16=True, seed=1, **CELL),
    "8100 lanes, volume frames": dict(wp=8100, volume=True, seed=2, **CELL),
    "2025 lanes, roulette": dict(wp=2025, rr=True, seed=3, **CELL),
    "3001 lanes, a shard": dict(wp=3001, gr=12, size=(128, 128),
                                pix_lo=5000, n_local=6000, pix_mux=2,
                                seed=4),
    "1000 lanes, none live": dict(wp=1000, live=0.0, seed=5, **CELL),
    "8100 lanes, two-level sampler": dict(wp=8100, rr=True, volume=True,
                                          seed=6, **CELL),
}


@pytest.mark.chip
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_the_kernel_is_the_twin_on_the_card(card, name):
    kw = dict(CARD_CASES[name])
    sampler = "hier" if "two-level" in name else "row"
    x, fr = _case(kw.pop("wp"), kw.pop("gr"), **kw)
    x = _to(x, card)
    k_stats, t_stats = _stats(card), _stats(card)
    launches = st.KERNEL.launches
    got = _run(WRAPPER, x, k_stats, fr, sampler)
    ref = _run(TWIN, x, t_stats, fr, sampler)
    torch.cuda.synchronize()
    assert st.KERNEL.launches == launches + 1
    for name_, a, b in zip(st.SLOT_FIELDS + ("sector", "pdf"),
                           got[0] + got[1:], ref[0] + ref[1:]):
        assert a.dtype == b.dtype and a.shape == b.shape, name_
        assert torch.equal(a, b), name_
    for k in st.STATS:
        assert torch.equal(k_stats[k], t_stats[k]), k
    live = bool(x["state"].active.any())
    assert (float(k_stats["path_sum"]) > 17) == live


@pytest.mark.chip
@pytest.mark.parametrize("sampler", ["row", "hier"])
def test_a_traced_card_frame_launches_the_kernel_every_step(card, sampler):
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=2,
                       max_ray_bounces=8)
    _frame(card, cfg, sampler)            # every first call, unrecorded
    torch.cuda.synchronize()
    profiling.RECORDER.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _frame(card, cfg, sampler)
        torch.cuda.synchronize()
    rec = profiling.RECORDER
    assert rec.counts["sarsa_wavefront.steps"] > 0
    assert (rec.counts["sarsa_wavefront.transport_launches"]
            == rec.counts["sarsa_wavefront.steps"])
