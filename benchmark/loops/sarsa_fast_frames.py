"""Learning frames of the fine-map expected-SARSA tracer, as ``render --mode
sarsa-fast`` and ``evaluate``'s training chunks run them: one user asks
for an 8-spp frame through ``render_frame_sarsa_wavefront``, which updates
the radiance volumes' Q table by TD while it renders and rebuilds their
CDF at its end, waits for the device, and asks for the next.  The volumes
start from their initial state and are carried from frame to frame, as
the reference's mode 1 carries them; the answer table is built once.  The
warm-up renders the same shapes on a copy of the volumes, so the window's
frames are the first of the learning trajectory.

The comparison follows the program's own state, stage by stage, because
the TD scatter's atomics sum in any order and a frame's randomness and its
in-place learning rule out a rerun: the program's capture hook
(``sarsa_wavefront.CAPTURE``) keeps, in every frame of the window, its
first step, one step drawn from the seed among the first ``draw_below``
of the warm-up's widest phase and the final phase's last steps, every
flush, and the frame's Q and visits before its CDF rebuild and the CDF
after.  The check takes a
frame drawn evenly over the window (its drawn step) and the window's last
frame (its last step with a live slot), and recomputes with the plain
reference (``reference/sarsa_volumes.py``, and ``reference/pathtrace.py``'s
closest hit over the reference's own tables):

* ``init_gap``: the initial volume set (positions, normals, luminances,
  Q, visits, CDF) against the reference's own, the largest difference;
* ``carry_gap``: the tables each checked frame starts from (its step 0's
  Q, visits and CDF rows) against those the frame before it ended with
  (its final Q and visits and its rebuilt CDF; the initial set for the
  window's first frame), the largest difference;
* ``hit_gap``: as the deep cell's (``loops/neural_q_frames.py``: the share
  of live rays on another triangle or miss, the relative gaps of the
  distance, the material row, the point, the survivors' next origin and
  direction), and the share of surface hits whose class id (the
  material row's column 11) is not the reference's;
* ``vol_gap``: the share of surface hits whose volume is of another
  normal than the hit triangle's, or lies farther from the hit than its
  nearest volume of that normal (brute force) by more than the
  quantisation the configuration's ``answer_table`` allows
  (``sarsa_volumes.allowance``: from its cell size, not the program's
  table); the share whose volume is not the hit's nearest at all is the
  fourth number of each ``checked`` entry;
* ``q_gap``: the step's TD targets and running means from the program's
  Q and visits before it, against its Q after: the largest relative gap
  over the entries updated (1 where an entry not updated changed);
* ``visits_gap``: the largest gap of the visit counts after the step;
* ``irr_gap``: the refreshed irradiance column against the estimate from
  the program's Q after the step, the largest relative gap;
* ``sector_gap``: the share of surface hits whose sector the reference
  draws otherwise from the program's CDF rows and uniforms;
* ``rad_gap``: the step's transport from the program's hits and the
  reference's sectors: the banked slot rows, the survivors' throughput
  and radiance (sum |d| / sum |ref|), the regenerated camera rays, and
  the share of lanes whose slot state (pixel, sample, bounce, pending
  volume and sector, liveness) differs;
* ``cdf_gap``: the frame's CDF against the rebuild of its final Q, the
  largest difference;
* ``img_gap``: the frame's image against the reference's assembly of the
  banked rows of every flush of the frame.

The frame metrics (``metrics/paths_per_s.py``) read a loop of frames by
the name ``progressive``, so ``prepare`` gives the run's mix that name
once this loop is loaded: a user's frames back to back, each
synchronised, which is what they measure.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import random
import time

import torch

from benchmark.loops import common
from benchmark.loops.neural_q_frames import (NAN_GAP, _rel_l1, _rel_max,
                                             armed, hit_gap, last_live)
from benchmark.reference import neural_q as nqr
from benchmark.reference import pathtrace as pt
from benchmark.reference import sarsa_volumes as svr

GAPS = ("init_gap", "carry_gap", "hit_gap", "vol_gap", "q_gap", "visits_gap",
        "irr_gap", "sector_gap", "rad_gap", "cdf_gap", "img_gap")
INTS = ("pixel", "kmx", "bounce", "remaining", "active", "cur_vol",
        "cur_sector")


def _configs(c: dict, t: dict):
    from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
    vc = c["volumes"]
    cfg = RenderConfig(width=c["width"], height=c["height"],
                       samples_per_pixel=t["spp"],
                       max_ray_bounces=c["max_ray_bounces"],
                       environment_light=c["environment_light"],
                       eps=c["eps"], russian_roulette=c["russian_roulette"])
    rl = RadianceVolumeConfig(grid_resolution=vc["sector_grid"],
                              area_per_sample=vc["area_per_sample"],
                              distribution_threshold=vc[
                                  "distribution_threshold"],
                              defensive_mix=vc["defensive_mix"])
    for name in ("initial_radiance", "radiance_threshold"):
        if not math.isclose(getattr(rl, name), vc[name], rel_tol=1e-12):
            raise ValueError(f"the program's {name} is {getattr(rl, name)}, "
                             f"the configuration's {vc[name]}")
    return cfg, rl


def prepare(run):
    from rlrpt_tpu_torch.integrators import sarsa_wavefront as sw
    if not hasattr(sw, "Capture"):
        raise RuntimeError("this program's SARSA wavefront has no capture "
                           "hook (sarsa_wavefront.Capture) to compare from")
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.radiance.grid_bucket import build_volume_class_table
    from rlrpt_tpu_torch.radiance.volumes import build_radiance_volumes
    c, t = run.config, run.traffic
    if c["russian_roulette"]:
        raise ValueError("the reference's transport has no Russian roulette")
    vc = c["volumes"]
    scene = common.scene_module(c).program_scene(c, run.device)
    run.mark("scene")
    cfg, rl = _configs(c, t)
    vols = build_radiance_volumes(scene, rl, seed=vc["seed"])
    if vc["n_volumes"] is not None and vols.n_volumes != vc["n_volumes"]:
        raise ValueError(f"{vols.n_volumes} volumes, the configuration's "
                         f"{vc['n_volumes']}")
    run.mark("volumes")
    table = build_volume_class_table(vols, scene)
    run.mark("table")
    run.paths_per_answer = cfg.n_pixels * cfg.samples_per_pixel
    run.extra["sarsa"] = {"n_tris": scene.n_triangles,
                          "n_volumes": vols.n_volumes}
    sched = c["schedule"]
    state = {"scene": scene, "camera": Camera.create(c["camera"]),
             "cfg": cfg, "rl": rl, "vols": vols, "init": vols,
             "table": table, "sw": sw,
             "kw": dict(pix_mux=sched["pix_mux"], hit_mode=sched["hit_mode"],
                        sampler=sched["sampler"], cdf_dtype=vc["cdf_dtype"]),
             "render": _faulty(sw.render_frame_sarsa_wavefront, run)}
    # the warm-up: the window's shapes, the capture's included, on a copy
    warm = random.Random(run.seed ^ 0x5EED)
    w_vols = dataclasses.replace(vols, q=vols.q.clone(),
                                 visits=vols.visits.clone(),
                                 cdf=vols.cdf.clone())
    for _ in range(t["warmup_frames"]):
        cap = sw.Capture(iterations=(0, 1), tail=True)
        with armed(sw, cap):
            _, w_vols, aux = state["render"](
                warm.randrange(0, 2 ** 31 - 1), scene, state["camera"],
                w_vols, table, cfg, rl, **state["kw"])
        common.synchronize(run.device)
        # the widest phase's steps (each has a live slot: its iterations)
        state["wide_steps"] = int(aux["phase_iterations"][0])
    del w_vols, cap
    run.mark("warmup")
    # a loop of frames, as the frame metrics name one (the docstring)
    run.traffic["loop"] = "progressive"
    return state


def window(run, state):
    t = run.traffic
    sw, scene, camera = state["sw"], state["scene"], state["camera"]
    cfg, rl, table, dev = state["cfg"], state["rl"], state["table"], run.device
    vols = state["vols"]
    # the tables each frame should start from: the last frame's result
    prev = {"q": vols.q, "visits": vols.visits, "cdf": vols.cdf}
    seeds = random.Random(run.rng.randrange(2 ** 62))
    picks = random.Random(run.rng.randrange(2 ** 62))
    top = max(2, int(state["wide_steps"] * t["draw_below"]))
    sample = common.Sample(run.rng, 1)
    span = run.spans.span
    with _planted(run, sw), common.Window(run) as w:
        while w.open():
            i = run.answers
            s = seeds.randrange(0, 2 ** 31 - 1)
            step = picks.randrange(1, top)
            cap = sw.Capture(iterations=(0, step), tail=True)
            t0 = time.perf_counter()
            with span("frame"), armed(sw, cap):
                with span("render_frame_sarsa_wavefront"):
                    img, vols, _ = state["render"](s, scene, camera, vols,
                                                   table, cfg, rl,
                                                   **state["kw"])
                with span("sync"):
                    common.synchronize(dev)
            w.answer(time.perf_counter() - t0)
            sample.offer({"index": i, "img": img, "cap": cap,
                          "step": step, "prev": prev})
            prev = {"q": cap.q_final, "visits": cap.visits_final,
                    "cdf": cap.cdf}
    init = state["init"]
    return {"drawn": sample.drawn, "last": sample.last,
            "init": {k: getattr(init, k) for k in (
                "position", "normal", "surface_lum", "q", "visits", "cdf")}}


# ---- planted faults (the tests) ---------------------------------------------

def _faulty(render, run):
    """The frame with the run's ``sarsa`` fault ``image_scaled`` (the image
    returned 1% brighter) or ``not_carried`` (the frame returns the volumes
    it was given, so the next starts from the same tables)."""
    fault = run.extra.get("faults", {}).get("sarsa")

    def scaled(*args, **kwargs):
        img, *rest = render(*args, **kwargs)
        return (img * 1.01, *rest)

    def not_carried(*args, **kwargs):
        img, _, aux = render(*args, **kwargs)
        return img, args[3], aux
    return {"image_scaled": scaled,
            "not_carried": not_carried}.get(fault, render)


@contextlib.contextmanager
def _planted(run, sw):
    """The window's frames as the run's ``sarsa`` fault breaks them: the
    TD scatter ``half_td`` (every second lane's pending update dropped),
    the nearest volume ``next_vol_shifted`` (every answer moved to the next
    volume), the rebuild ``cdf_not_rebuilt`` (the volumes keep their CDF)."""
    fault = run.extra.get("faults", {}).get("sarsa")
    if fault == "half_td":
        name, sound = "sarsa_contributions", sw.sarsa_contributions

        def broken(vol_idx, sector, target, mask, v, s, scratch=None):
            keep = torch.arange(mask.shape[0], device=mask.device) % 2 == 0
            return sound(vol_idx, sector, target, mask & keep, v, s, scratch)
    elif fault == "next_vol_shifted":
        name, sound = "find_closest_volume_table", sw.find_closest_volume_table

        def broken(tb, qpos, tri, cls=None):
            ans = sound(tb, qpos, tri, cls=cls)
            return (ans + 1) % run.extra["sarsa"]["n_volumes"]
    elif fault == "cdf_not_rebuilt":
        name, sound = "rebuild_cdf", sw.rebuild_cdf

        def broken(vols, *args, **kwargs):
            return vols
    else:
        yield
        return
    setattr(sw, name, broken)
    try:
        yield
    finally:
        setattr(sw, name, sound)


# ---- the comparison ---------------------------------------------------------

def _max_abs(got, ref) -> float:
    if got.shape != ref.shape:
        return 1.0
    if ref.numel() == 0:
        return 0.0
    return float((got.double() - ref.double()).abs().max())


def _rel_each(got, ref) -> float:
    """The largest |got - ref| / |ref| over the elements."""
    if ref.numel() == 0:
        return 0.0
    got, ref = got.double(), ref.double()
    return float(((got - ref).abs() / ref.abs().clamp(min=1e-300)).max())


def init_gap(vols: dict, ref: dict) -> float:
    """The largest difference between the volume sets' positions,
    normals, luminances, Q, visits and CDF (1 for another count)."""
    return max(_max_abs(vols[k], ref[k]) for k in (
        "position", "normal", "surface_lum", "q", "visits", "cdf"))


def step_gaps(rec, ref_vs: dict, tables, packed, c: dict, grid: int,
              class_ref, low=None) -> dict:
    """Every step-level gap of one record (the module's docstring), and
    ``not_nearest``, the share of surface hits whose volume is not the
    hit's nearest; with ``low``, the reference computed in that dtype
    stands in for the program (the same inputs, the same comparisons)."""
    st = rec["state"]
    act = st.active
    ft = low or torch.float32
    s = grid * grid
    ns, dev = tables.n_surfaces, act.device
    t, tri, mrow, nv = rec["t"], rec["tri"].long(), rec["mrow"], \
        rec["next_vol"]
    normal = mrow[:, 0:3]
    missed, light, surf = nqr.hit_masks(act, t, tri, ns)
    out = {}

    # the sector, from the program's CDF rows and uniforms
    rows = rec["cdfplus"][nv, :s]
    sec_ref, pdf_ref, dir_ref = svr.sample(rows, rec["r"], rec["u"], normal,
                                           grid)
    sec_got = (svr.sample(rows, rec["r"], rec["u"], normal, grid, low)[0]
               if low else rec["sector"])
    out["sector_gap"] = (float((sec_got[surf] != sec_ref[surf]).double()
                               .mean()) if bool(surf.any()) else 0.0)

    # the closest hit: the reference's sweep over its own tables
    tris, mat = packed[0]

    def hit(tris, mat):
        o, d = st.o.to(tris.dtype), st.d.to(tris.dtype)
        ht, htri = pt.closest_hit(o[:, 0], o[:, 1], o[:, 2], d[:, 0],
                                  d[:, 1], d[:, 2], tris)[:2]
        hrow = mat[htri]
        qpos = o + ht[:, None] * d
        nd = nqr.direction(sec_ref, rec["u"].to(tris.dtype), hrow[:, 0:3],
                           grid)
        return {"t": ht, "tri": htri, "mrow": hrow, "qpos": qpos,
                "o": qpos + c["eps"] * nd, "d": nd}
    h_ref = hit(tris, mat)
    h_got = (hit(*packed[1]) if low else
             {"t": t, "tri": tri, "mrow": mrow,
              "qpos": st.o + t[:, None] * st.d, "o": rec["out"].o,
              "d": rec["out"].d})
    same = surf & (h_ref["tri"] == tri)
    cls = (0.0 if low or not bool(same.any()) else float(
        (mrow[same, 11].round().long() != class_ref[tri[same]]).double()
        .mean()))
    out["hit_gap"] = max(cls, hit_gap(rec, h_ref, h_got, ns,
                                      c["max_ray_bounces"]))

    # the nearest volume at the hit, up to the stated table's quantisation
    qpos = (st.o + t[:, None] * st.d)[surf]
    qn = torch.as_tensor(tables.normal, device=dev)[tri[surf]]
    vpos, vnormal = ref_vs["position"], ref_vs["normal"]
    ans = (svr.nearest(qpos, qn, vpos, vnormal, ft=low)[0] if low
           else nv[surf])
    far = svr.excess(ans, qpos, qn, vpos, vnormal)
    at = c["answer_table"]
    slack = svr.allowance(qpos, vpos, at["cell"], at["margin"])
    share = lambda m: float(m.double().mean()) if m.numel() else 0.0  # noqa
    out["vol_gap"] = share(far > slack + svr.TIE)
    out["not_nearest"] = share(far > svr.TIE)

    # the TD targets and the running means, from the Q and visits before
    lum = mat[tri][:, 10]
    irr = svr.irradiance(rec["q"], ref_vs["surface_lum"], grid)
    pending = act & (st.cur_sector >= 0)
    target = svr.td_targets(st.cur_brdf, missed, light, lum, irr[nv],
                            c["environment_light"])
    entries = (st.cur_vol * s + st.cur_sector)[pending]
    thr = c["volumes"]["radiance_threshold"]
    q_ref, v_ref, touched = svr.update(rec["q"], rec["visits"], entries,
                                       target[pending], thr)
    if low:
        target_low = svr.td_targets(st.cur_brdf, missed, light, lum,
                                    svr.irradiance(rec["q"],
                                                   ref_vs["surface_lum"],
                                                   grid, low)[nv],
                                    c["environment_light"], low)
        q_got, v_got, _ = svr.update(rec["q"], rec["visits"], entries,
                                     target_low[pending], thr, low)
    else:
        q_got, v_got = rec["q_after"], rec["visits_after"]
    flat_got, flat_ref = q_got.reshape(-1), q_ref.reshape(-1)
    kept_q = torch.ones_like(flat_ref, dtype=torch.bool)
    kept_q[touched] = False
    # an entry no target reached keeps its Q (the program's own check)
    moved = not low and bool((flat_got[kept_q]
                              != rec["q"].reshape(-1)[kept_q]).any())
    out["q_gap"] = 1.0 if moved else _rel_each(flat_got[touched],
                                               flat_ref[touched])
    out["visits_gap"] = _max_abs(v_got.long(), v_ref)

    # the irradiance column refreshed from the program's Q after the step
    irr_ref = svr.irradiance(rec["q_after"], ref_vs["surface_lum"], grid)
    irr_got = (svr.irradiance(rec["q_after"], ref_vs["surface_lum"], grid,
                              low) if low else rec["irr"])
    out["irr_gap"] = _rel_each(irr_got, irr_ref)

    # the transport, from the program's hits and the reference's sectors
    fr = common.frame(c, rec["spp"])
    args = (st._asdict(), t, tri, mrow, nv, sec_ref, pdf_ref, dir_ref,
            rec["u_pix"], ns, fr, common.camera(c), rec["w0"],
            st.slot_rad.shape[1])
    ref = svr.transport(*args)
    got = svr.transport(*args, ft=low) if low else rec["out"]._asdict()
    surv, regen = ref["survive"], ref["regen"]
    ints = torch.zeros_like(act)
    for k in INTS:
        ints |= got[k].long() != ref[k].long()
    out["rad_gap"] = max(
        _rel_l1(got["slot_rad"], ref["slot_rad"]),
        _rel_l1(got["tp"][surv], ref["tp"][surv]),
        _rel_l1(got["sample_rad"][surv], ref["sample_rad"][surv]),
        _rel_max(got["cur_brdf"][surv], ref["cur_brdf"][surv]),
        _rel_max(got["d"][regen], ref["d"][regen]),
        _rel_max(got["o"][regen], ref["o"][regen]),
        float(ints.double().mean()))
    return out


def check(run, kept, control: bool = False):
    """Compare the kept frames with the reference, stage by stage.  With
    ``control``, the reference computed in bfloat16 stands in the
    program's place (the same inputs, the same comparisons)."""
    c, t = run.config, run.traffic
    vc, dev = c["volumes"], run.device
    low = common.CONTROL_DTYPE if control else None
    grid, spp = vc["sector_grid"], t["spp"]
    drawn, last = kept["drawn"], kept["last"]
    frames = drawn if any(f is last for f in drawn) else drawn + [last]
    # [frame, step, width, the share of hits off their nearest volume] a
    # record checked
    run.extra["checked"] = []
    tables = common.scene_module(c).reference_tables(c)
    packed = (tables.packed(dev), tables.packed(dev, common.CONTROL_DTYPE))
    vs_args = (tables, vc["area_per_sample"], grid, vc["initial_radiance"],
               vc["seed"], dev)
    ref_vs = svr.volume_set(*vs_args)
    class_ref = torch.as_tensor(svr.class_ids(tables), device=dev)
    n_pix = c["width"] * c["height"]
    out = dict.fromkeys(GAPS, 0.0)

    def keep_max(name, value):
        if value != value:        # NaN: as far off as a reading can be
            value = NAN_GAP
        out[name] = max(out[name], value)

    keep_max("init_gap", init_gap(
        svr.volume_set(*vs_args, ft=low) if low else kept["init"], ref_vs))
    for f in frames:
        cap = f["cap"]
        # the tables the frame started from against the last one's result
        start, prev = cap.records.get(0), f["prev"]
        if start is None:
            keep_max("carry_gap", NAN_GAP)
        else:
            got = ({k: v.to(low) for k, v in prev.items()} if low else
                   {"q": start["q"], "visits": start["visits"],
                    "cdf": start["cdfplus"][:, :grid * grid]})
            keep_max("carry_gap", max(_max_abs(got[k], prev[k])
                                      for k in ("q", "visits", "cdf")))
        recs = []
        if any(f is g for g in drawn):
            recs.append(cap.records.get(f["step"]) or last_live(cap))
        if f is last:
            recs.append(last_live(cap))
        for rec in (r for r in recs if r is not None):
            gaps = step_gaps(dict(rec, spp=spp, w0=cap.w0), ref_vs, tables,
                             packed, c, grid, class_ref, low)
            run.extra["checked"].append([f["index"], rec["step"],
                                         rec["width"],
                                         gaps.pop("not_nearest")])
            for name, value in gaps.items():
                keep_max(name, value)
        cdf_ref = svr.rebuild_cdf(cap.q_final, grid,
                                  vc["distribution_threshold"])
        cdf_got = (svr.rebuild_cdf(cap.q_final, grid,
                                   vc["distribution_threshold"], low)
                   if low else cap.cdf)
        keep_max("cdf_gap", _max_abs(cdf_got, cdf_ref))
        ref_img = nqr.assemble(cap.flushes, n_pix, cap.w0, spp)
        got_img = (nqr.assemble(cap.flushes, n_pix, cap.w0, spp, low)
                   if low else f["img"].reshape(-1, 3))
        keep_max("img_gap", _rel_l1(got_img, ref_img))
    return common.judge(run, out)
