"""Back-to-back learning jobs on the binned Q-state, as
``render --mode sarsa-mega --frames N`` runs one: a fresh Q and visit
table (``init_bin_q``) and its CDF (``rebuild_bin_cdf``), N learning
frames of ``spp`` samples (``render_sarsa_mega_train``, each followed by
``rebuild_bin_cdf``), then a guided render at ``guided_spp`` with the
learned table (``render_guided_mega``) and a wait for the device.  One
client: a job starts when the last one has finished.  Every job has its
own kernel seeds, drawn from the run's seed.

The comparison follows two jobs, one drawn from the seed evenly over the
whole window and the window's last, from the program's own state, stage
by stage, because a learning frame adds its TD targets with atomics: its
Q differs from any other summation order in the last bits, and a bf16
rebuild can round such a Q to another table, after which the paths of
the two sides part.  So, over both jobs:

* ``init_gap``: the program's fresh Q and visits against the reference's
  (largest absolute difference);
* ``cdf_gap``: every rebuilt table (the fresh one and one after each
  learning frame) against the reference's rebuild of the program's Q
  that it was built from: the share of entries that differ;
* ``q_gap``, ``visits_gap``, ``b2_img_gap``, ``b2_path_gap``: a learning
  frame of the drawn job drawn from the seed, and the last learning frame
  of the last job, rerun by the reference from the program's Q, visits and
  table before it: the largest |dQ| over the largest |Q|, the largest
  difference of a visit count, and the image and mean path length as in
  the progressive loop;
* ``b3_img_gap``, ``b3_path_gap``: each job's guided render, rerun by the
  reference from the program's last table over pixels drawn as in the
  progressive loop (``check_pairs`` shared between the jobs).

``image_mape`` is the thesis's MAPE of every job's guided image against
the configuration's pinned ground truth (``Mape``).
"""

from __future__ import annotations

import random
import time

import torch

from benchmark import imagecmp
from benchmark.loops import common
from benchmark.reference import pathtrace as pt


def prepare(run):
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import RenderConfig
    from rlrpt_tpu_torch.ops import guided_mega as gm
    from rlrpt_tpu_torch.ops import guided_mega_train as gmt
    from rlrpt_tpu_torch.ops.megakernel import _t_pad
    c, t = run.config, run.traffic
    scene_mod = common.scene_module(c)
    scene = scene_mod.program_scene(c, run.device)
    run.mark("scene")
    kw = dict(width=c["width"], height=c["height"],
              max_ray_bounces=c["max_ray_bounces"],
              environment_light=c["environment_light"], eps=c["eps"],
              russian_roulette=c["russian_roulette"])
    lc = c["learning"]
    state = {
        "scene": scene, "camera": Camera.create(c["camera"]),
        "t_pad": _t_pad(scene.n_triangles),
        "learn_cfg": RenderConfig(samples_per_pixel=t["spp"], **kw),
        "guided_cfg": RenderConfig(samples_per_pixel=t["guided_spp"], **kw),
        "init": gmt.init_bin_q, "rebuild": gmt.rebuild_bin_cdf,
        "learn": common.faulty(gmt.render_sarsa_mega_train, "learn", run),
        "guided": common.faulty(gm.render_guided_mega, "render", run),
        "lc": lc}
    n_pix = c["width"] * c["height"]
    run.paths_per_answer = n_pix * t["guided_spp"]
    run.extra.update(
        n_tris=scene.n_triangles, n_slots=common.n_slots(c),
        n_cols=pt.t_pad(c["scene"]["triangles"]) * lc["uv_bins"] ** 2,
        n_sectors_pad=-(-lc["sector_grid"] ** 2 // 8) * 8,
        learn_paths=n_pix * t["spp"], kernel_segments={"B2": [], "B3": []})
    if c.get("gt") is not None:
        state["mape"] = Mape(imagecmp.load_gt(run.root, c["gt"]), run.device)
    warm = random.Random(run.seed ^ 0x5EED)
    seg = {"B2": common.SegmentLog(run.device, t["warmup_jobs"] * t["frames"]),
           "B3": common.SegmentLog(run.device, t["warmup_jobs"])}
    for _ in range(t["warmup_jobs"]):     # the window's calls, in its order
        job(run, state, warm, seg, None)
    if "mape" in state:
        state["mape"].sums = common.SegmentLog(run.device)
    run.mark("warmup")
    return state


class Mape:
    """The thesis's MAPE (a frozen copy of
    rlrpt_tpu_torch/utils/image.py:mape_score) of each guided image, its
    sum taken on the device in float64 as the job ends, so the window keeps
    no image; the scores are read, divided and rounded after the window."""

    def __init__(self, gt, device):
        g = torch.as_tensor(gt, dtype=torch.float64, device=device)
        self.shape = tuple(g.shape)
        self.gt = g / 255.0
        self.den = (g + 0.01) / 255.0
        self.sums = common.SegmentLog(device)

    def add(self, img) -> None:
        if tuple(img.shape) != self.shape:
            raise ValueError(f"image {tuple(img.shape)} against a ground "
                             f"truth of {self.shape}")
        self.sums.add((torch.abs(self.gt - img.double() / 255.0)
                       / self.den).sum())

    def scores(self) -> list:
        n = 1
        for d in self.shape:
            n *= d
        return [round(v / n, 4) for v in self.sums.values()]


def job(run, state, seeds, seg, record):
    """One learning job; ``record`` (a dict) keeps every stage's output."""
    span = run.spans.span
    lc, gr, ub = state["lc"], state["lc"]["sector_grid"], \
        state["lc"]["uv_bins"]
    scene, camera, dev = state["scene"], state["camera"], run.device
    t_pad = state["t_pad"]
    with span("init_bin_q"):
        q, vis = state["init"](t_pad, ub, gr, lc["initial_radiance"],
                               device=dev)
    with span("rebuild_bin_cdf"):
        table = state["rebuild"](q, gr, ub, t_pad,
                                 defensive_mix=lc["defensive_mix"])
    if record is not None:
        record.update(q0=q, v0=vis, tables=[table], frames=[])
    for _ in range(run.traffic["frames"]):
        s = seeds.randrange(0, 2 ** 31 - 1)
        with span("render_sarsa_mega_train"):
            img, q_new, vis_new, aux = state["learn"](
                s, scene, camera, table, q, vis, state["learn_cfg"],
                lc["radiance_threshold"], dev)
        if seg is not None:
            seg["B2"].add(aux["avg_path_length"])
        if record is not None:
            record["frames"].append((s, q, vis, img, q_new, vis_new, aux))
        q, vis = q_new, vis_new
        with span("rebuild_bin_cdf"):
            table = state["rebuild"](q, gr, ub, t_pad,
                                     defensive_mix=lc["defensive_mix"])
        if record is not None:
            record["tables"].append(table)
    s = seeds.randrange(0, 2 ** 31 - 1)
    with span("render_guided_mega"):
        img, aux = state["guided"](s, scene, camera, table,
                                   state["guided_cfg"], dev)
    if seg is not None:
        seg["B3"].add(aux["avg_path_length"])
    if record is not None:
        record["guided"] = (s, img, aux)
    if seg is not None and "mape" in state:
        state["mape"].add(img)
    with span("sync"):
        common.synchronize(dev)


def window(run, state):
    seeds = random.Random(run.rng.randrange(2 ** 62))
    sample = common.Sample(run.rng, 1)
    seg = {k: common.SegmentLog(run.device) for k in ("B2", "B3")}
    with common.Window(run) as w:
        while w.open():
            rec = {"index": run.answers}
            t0 = time.perf_counter()
            with run.spans.span("job"):
                job(run, state, seeds, seg, rec)
            w.answer(time.perf_counter() - t0)
            sample.offer(rec)
    run.extra["kernel_segments"] = {
        "B2": [a * run.extra["learn_paths"] for a in seg["B2"].values()],
        "B3": [a * run.paths_per_answer for a in seg["B3"].values()]}
    if "mape" in state:
        run.extra["image_mape"] = state["mape"].scores()
    return {"drawn": sample.drawn, "last": sample.last}


def _q_gap(q, ref) -> float:
    q, ref = q.double(), ref.double()
    return float((q - ref).abs().max() / ref.abs().max().clamp(min=1e-300))


def _max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check(run, kept, control: bool = False):
    """Compare the kept jobs with the reference, stage by stage.  With
    ``control``, the reference computed in bfloat16 stands in the program's
    place (the same inputs, the same comparisons)."""
    c, t = run.config, run.traffic
    lc, dev = c["learning"], run.device
    gr, ub = lc["sector_grid"], lc["uv_bins"]
    drawn, last = kept["drawn"], kept["last"]
    jobs = drawn if any(r is last for r in drawn) else drawn + [last]
    run.extra["checked"] = [r["index"] for r in jobs]
    tables = common.scene_module(c).reference_tables(c)
    tris, mat = tables.packed(dev)
    low = tables.packed(dev, common.CONTROL_DTYPE)
    lum = tables.luminance_tensor(dev)
    cam = common.camera(c)
    n_slots = common.n_slots(c)
    n_cols = pt.t_pad(tables.n_triangles) * ub * ub
    thr = lc["radiance_threshold"]
    fr = common.frame(c, t["spp"])
    gfr = common.frame(c, t["guided_spp"])
    n_pix = fr.n_pix
    out = dict.fromkeys(("init_gap", "cdf_gap", "q_gap", "visits_gap",
                         "b2_img_gap", "b2_path_gap", "b3_img_gap",
                         "b3_path_gap"), 0.0)

    def rebuild(q, dtype):
        return pt.rebuild_cdf(q.to(dtype), gr, lc["distribution_threshold"],
                              lc["defensive_mix"])

    def keep_max(name, value):
        out[name] = max(out[name], value)

    q0, v0 = pt.init_q(n_cols, gr, lc["initial_radiance"], dev,
                       torch.float32)
    for rec in jobs:
        cand = (pt.init_q(n_cols, gr, lc["initial_radiance"], dev,
                          common.CONTROL_DTYPE) if control
                else (rec["q0"], rec["v0"]))
        keep_max("init_gap", max(_max_abs(cand[0], q0),
                                 _max_abs(cand[1], v0)))
        n_frames = len(rec["frames"])
        for i, table in enumerate(rec["tables"]):
            q = rec["q0"] if i == 0 else rec["frames"][i - 1][4]
            ref = rebuild(q, torch.float32)
            got = (rebuild(q, common.CONTROL_DTYPE) if control
                   else table.cdf.to(ref.device))
            keep_max("cdf_gap", float((got != ref).double().mean()))
        picks = set()
        if any(rec is r for r in drawn):
            picks.add(run.rng.randrange(n_frames))
        if rec is last:
            picks.add(n_frames - 1)
        for k in sorted(picks):
            s, q_in, v_in, img, q_out, v_out, aux = rec["frames"][k]
            cdf = rec["tables"][k].cdf.to(dev)
            rad, path_sum, _, q_ref, v_ref, _ = pt.learn_frame(
                s, cam, tris, mat, fr, n_slots, common.PIX_MUX, cdf, lum,
                q_in, v_in, gr, ub, thr)
            ref_img = (rad.reshape(-1, 3)[:n_pix] / fr.spp).double()
            ref_len = float(path_sum.double().sum()) / (n_pix * fr.spp)
            if control:
                rad, path_sum, _, q_out, v_out, _ = pt.learn_frame(
                    s, cam, *low, fr, n_slots, common.PIX_MUX, cdf, lum,
                    q_in, v_in, gr, ub, thr)
                img = rad.reshape(-1, 3)[:n_pix] / fr.spp
                got_len = float(path_sum.double().sum()) / (n_pix * fr.spp)
            else:
                got_len = float(aux["avg_path_length"])
            keep_max("q_gap", _q_gap(q_out, q_ref))
            keep_max("visits_gap", _max_abs(v_out, v_ref))
            keep_max("b2_img_gap", imagecmp.rel_l1(
                img.reshape(-1, 3).double().cpu().numpy(),
                ref_img.cpu().numpy()))
            keep_max("b2_path_gap", imagecmp.rel_gap(got_len, ref_len))

        s, img, aux = rec["guided"]
        pix = common.draw_slots(run.rng, gfr.n_pix, common.check_pixels(
            t["check_pairs"] // len(jobs), run.extra["n_tris"], gfr), dev)
        cdf = (gr, ub, rec["tables"][-1].cdf.to(dev).T.contiguous())
        rad, path_sum, _ = pt.render(s, cam, tris, mat, gfr, n_slots,
                                     common.PIX_MUX, pix, cdf=cdf)
        ref_len = float(path_sum.double().sum()) / (pix.shape[0] * gfr.spp)
        if control:
            rad_c, ps_c, _ = pt.render(s, cam, *low, gfr, n_slots,
                                       common.PIX_MUX, pix, cdf=cdf)
            got = rad_c[0] / gfr.spp
            got_len = float(ps_c.double().sum()) / (pix.shape[0] * gfr.spp)
        else:
            got = img.reshape(-1, 3)[pix]
            got_len = float(aux["avg_path_length"])
        keep_max("b3_img_gap", imagecmp.rel_l1(
            got.double().cpu().numpy(),
            (rad[0] / gfr.spp).double().cpu().numpy()))
        keep_max("b3_path_gap", imagecmp.rel_gap(got_len, ref_len))
    return common.judge(run, out)
