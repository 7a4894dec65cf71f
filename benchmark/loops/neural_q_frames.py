"""Learning frames of the deep-Q path tracer, as ``render --mode neural-q``
runs them: one user asks for a 1-spp frame through
``render_frame_neural_q_wavefront``, which trains the Q-network online
while it renders, waits for the device, and asks for the next.  The
network and its Adam state start from a Glorot initialisation seeded by
the run's seed and are carried from frame to frame, as the reference's
mode 3 carries them; epsilon is the mix's.  The warm-up renders the same
shapes with a copy of the network, so the window's frames are the first
of the learning trajectory.

The comparison follows the program's own state, stage by stage, because
a frame's randomness and its in-place training rule out a rerun: the
program's capture hook (``deep_wavefront.CAPTURE``) keeps, in every frame
of the window, one iteration drawn from the seed among the first
``draw_below`` of the warm-up's widest phase (so it trains every
minibatch of the full slot width) and the final phase's last steps.  The
check takes a frame drawn evenly over the window (its drawn iteration)
and the window's last frame (its last iteration with a live slot), and
recomputes with the plain reference (``reference/neural_q.py``, and
``reference/pathtrace.py``'s closest hit over the reference's own
tables):

* ``hit_gap``: the closest hit of the iteration's rays, the largest of:
  the share of live rays whose triangle (or miss) differs, and, where
  the triangles agree, the largest relative gap of the distance, the
  material row (normal, diffuse, emission, light flag, luminance), the
  position forwarded ``o + t d``, and the survivors' next origin
  ``o + t d + eps d'`` and direction ``d'`` (the reference's sector);
* ``q_gap``: the forward on the explicit 342-wide encoding of the
  captured positions with the captured weights, against the program's Q
  rows, over the surface hits: the largest |dQ| over the largest |Q|;
* ``sector_gap``: the share of surface hits whose sector the reference
  draws otherwise from the program's Q rows and uniforms;
* ``td_gap``: the TD targets from the program's Q rows, largest gap over
  the largest target, over the live lanes;
* ``train_gap``: each of the iteration's minibatches, backward by hand
  and Adam, from the program's captured weights and moments before it:
  the norm of the gaps between the program's weights after each and the
  reference's over the norm of the reference's changes (1 where a step
  count differs).  Each step starts from the program's state, not from
  the reference's last: Adam turns a rounding gap that flips a ReLU or
  a gradient's sign near 0 into a whole step's gap, and the following
  steps drift apart from there (all 32 steps of an iteration from the
  reference's own states read up to 2.3e-2 in sound runs, PERF.md);
* ``rad_gap``: the iteration's transport from the program's hits and the
  reference's sectors: the banked slot rows, and the survivors'
  throughput and radiance (sum |d| / sum |ref|, the largest of three);
* ``img_gap``: the frame's image against the reference's assembly of the
  banked rows of every flush of the frame.

The frame metrics (``metrics/paths_per_s.py``) read a loop of frames by
the name ``progressive``, so ``prepare`` gives the run's mix that name
once this loop is loaded: a user's frames back to back, each
synchronised, which is what they measure.
"""

from __future__ import annotations

import contextlib
import copy
import math
import random
import time

import torch

from benchmark import imagecmp
from benchmark.loops import common
from benchmark.reference import neural_q as nqr
from benchmark.reference import pathtrace as pt

GAPS = ("hit_gap", "q_gap", "sector_gap", "td_gap", "train_gap", "rad_gap",
        "img_gap")
NAN_GAP = 1.0e30   # a gap read as NaN (the result line stays plain JSON)


def _configs(c: dict, t: dict):
    from rlrpt_tpu_torch.config import (DeepLearningConfig,
                                        RadianceVolumeConfig, RenderConfig)
    d = c["deep"]
    cfg = RenderConfig(width=c["width"], height=c["height"],
                       samples_per_pixel=t["spp"],
                       max_ray_bounces=c["max_ray_bounces"],
                       environment_light=c["environment_light"],
                       eps=c["eps"], russian_roulette=c["russian_roulette"])
    rl = RadianceVolumeConfig(grid_resolution=d["sector_grid"])
    dl = DeepLearningConfig(
        epsilon_start=d["epsilon_start"], epsilon_min=d["epsilon_min"],
        epsilon_decay=d["epsilon_decay"],
        train_on_position=d["train_on_position"],
        batch_size=d["batch_size"], hidden_sizes=tuple(d["hidden_sizes"]),
        learning_rate=d["learning_rate"], adam_b1=d["adam_b1"],
        adam_b2=d["adam_b2"], adam_eps=d["adam_eps"],
        light_reward_scale=d["light_reward_scale"])
    return cfg, rl, dl


def prepare(run):
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.deep import deep_wavefront as dw
    from rlrpt_tpu_torch.deep.neural_q import init_neural_q
    if not hasattr(dw, "Capture"):
        raise RuntimeError("this program's deep wavefront has no capture "
                           "hook (deep_wavefront.Capture) to compare from")
    c, t = run.config, run.traffic
    if c["russian_roulette"]:
        raise ValueError("the reference's transport has no Russian roulette")
    scene = common.scene_module(c).program_scene(c, run.device)
    run.mark("scene")
    cfg, rl, dl = _configs(c, t)
    warm = random.Random(run.seed ^ 0x5EED)
    net, opt = init_neural_q(warm.randrange(2 ** 31), scene, dl,
                             rl.grid_resolution, run.device)
    sizes = (scene.vertices_count, *dl.hidden_sizes, rl.n_sectors)
    if sizes[0] != c["deep"]["input_width"]:
        raise ValueError(f"the scene's encoding is {sizes[0]} wide, the "
                         f"configuration's {c['deep']['input_width']}")
    run.paths_per_answer = cfg.n_pixels * cfg.samples_per_pixel
    run.extra["deep"] = {"n_tris": scene.n_triangles, "sizes": sizes}
    state = {"scene": scene, "camera": Camera.create(c["camera"]),
             "cfg": cfg, "rl": rl, "dl": dl, "net": net, "opt": opt,
             "eps": float(t["epsilon"]), "dw": dw,
             "pix_mux": c["schedule"]["pix_mux"],
             "batching": c["schedule"]["train_batching"],
             "render": _faulty(dw.render_frame_neural_q_wavefront, run)}
    # the warm-up: the window's shapes, the capture's included, on a copy
    w_net, w_opt = copy.deepcopy(net), _copy_adam(opt)
    eps = state["eps"]
    for _ in range(t["warmup_frames"]):
        cap = dw.Capture(iterations=(1,), tail=True)
        with armed(dw, cap):
            _, _, _, eps, aux = state["render"](
                warm.randrange(0, 2 ** 31 - 1), scene, state["camera"],
                w_net, w_opt, eps, cfg, rl, dl, pix_mux=state["pix_mux"],
                train_batching=state["batching"])
        common.synchronize(run.device)
        # the widest phase's steps (each has a live slot: its iterations)
        state["wide_steps"] = int(aux["phase_iterations"][0])
    del w_net, w_opt
    run.mark("warmup")
    # a loop of frames, as the frame metrics name one (the docstring)
    run.traffic["loop"] = "progressive"
    return state


def _copy_adam(opt):
    return type(opt)(count=opt.count.clone(),
                     mu=tuple(m.clone() for m in opt.mu),
                     nu=tuple(v.clone() for v in opt.nu))


@contextlib.contextmanager
def armed(dw, cap):
    dw.CAPTURE = cap
    try:
        yield cap
    finally:
        dw.CAPTURE = None


def window(run, state):
    t = run.traffic
    dw, scene, camera = state["dw"], state["scene"], state["camera"]
    cfg, rl, dl = state["cfg"], state["rl"], state["dl"]
    net, opt, dev = state["net"], state["opt"], run.device
    seeds = random.Random(run.rng.randrange(2 ** 62))
    picks = random.Random(run.rng.randrange(2 ** 62))
    top = max(2, int(state["wide_steps"] * t["draw_below"]))
    sample = common.Sample(run.rng, 1)
    span = run.spans.span
    eps = state["eps"]
    with _planted(run, dw), common.Window(run) as w:
        while w.open():
            i = run.answers
            s = seeds.randrange(0, 2 ** 31 - 1)
            cap = dw.Capture(iterations=(picks.randrange(1, top),),
                             tail=True)
            t0 = time.perf_counter()
            with span("frame"), armed(dw, cap):
                with span("render_frame_neural_q_wavefront"):
                    img, _, _, eps, _ = state["render"](
                        s, scene, camera, net, opt, eps, cfg, rl, dl,
                        pix_mux=state["pix_mux"],
                        train_batching=state["batching"])
                with span("sync"):
                    common.synchronize(dev)
            w.answer(time.perf_counter() - t0)
            sample.offer({"index": i, "img": img, "cap": cap})
    return {"drawn": sample.drawn, "last": sample.last}


# ---- planted faults (the tests) ---------------------------------------------

def _faulty(render, run):
    """The frame with the run's ``deep`` fault ``image_scaled``: the image
    returned 1% brighter."""
    if run.extra.get("faults", {}).get("deep") != "image_scaled":
        return render

    def scaled(*args, **kwargs):
        img, *rest = render(*args, **kwargs)
        return (img * 1.01, *rest)
    return scaled


@contextlib.contextmanager
def _planted(run, dw):
    """The window's frames as the run's ``deep`` fault breaks them: the
    training ``not_trained`` (the minibatches change nothing) or
    ``half_minibatches`` (every second one left out); the closest hit
    ``hit_far`` (every distance 0.1% long) or ``wrong_triangle`` (a hit
    reported on the next triangle, with that triangle's material row)."""
    fault = run.extra.get("faults", {}).get("deep")
    if fault in ("not_trained", "half_minibatches"):
        name, sound = "train_on_batches", dw.train_on_batches

        def broken(net, opt_state, scene, prev_loc, actions, tds, dl,
                   weights=None, mesh=None, on_step=None):
            if fault == "not_trained":
                return torch.zeros((), device=tds.device)
            w = weights.clone()
            b = min(dl.batch_size, w.shape[0])
            for s in range(b, w.shape[0], 2 * b):
                w[s:s + b] = 0.0
            return sound(net, opt_state, scene, prev_loc, actions, tds, dl,
                         weights=w, mesh=mesh, on_step=on_step)
    elif fault in ("hit_far", "wrong_triangle"):
        name, sound = "closest_hit_mat_mxu", dw.closest_hit_mat_mxu

        def broken(o, d, tris, mat, m, bvh=None):
            t, tri, mrow = sound(o, d, tris, mat, m, bvh)
            hit = t < nqr.INF_CUT
            if fault == "hit_far":
                return torch.where(hit, t * 1.001, t), tri, mrow
            tri = torch.where(hit, (tri + 1) % tris.shape[0], tri)
            return t, tri, torch.where(hit[:, None], mat[tri.long()], mrow)
    else:
        yield
        return
    setattr(dw, name, broken)
    try:
        yield
    finally:
        setattr(dw, name, sound)


# ---- the comparison ---------------------------------------------------------

def _rel_max(got, ref) -> float:
    if ref.numel() == 0:
        return 0.0
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-300))


def _rel_l1(got, ref) -> float:
    return imagecmp.rel_l1(got.double().cpu().numpy(),
                           ref.double().cpu().numpy())


def _hit(o, d, tris, mat, sector, u, grid: int, eps: float) -> dict:
    """The reference's closest hit of the rays (o, d) over its tables
    (tris, mat) in their dtype: the distance ``t``, triangle ``tri``,
    material row ``mrow``, the point ``qpos``, and the next origin ``o``
    and direction ``d`` of a lane that leaves it by ``sector``."""
    ft = tris.dtype
    o, d = o.to(ft), d.to(ft)
    t, tri = pt.closest_hit(o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                            d[:, 2], tris)[:2]
    mrow = mat[tri]
    qpos = o + t[:, None] * d
    nd = nqr.direction(sector, u[:, 3:5].to(ft), mrow[:, 0:3], grid)
    return {"t": t, "tri": tri, "mrow": mrow, "qpos": qpos,
            "o": qpos + eps * nd, "d": nd}


def hit_gap(rec, ref: dict, got: dict, n_surfaces: int,
            max_bounces: int) -> float:
    """``hit_gap`` (the module's docstring) of one record's rays, ``got``
    against ``ref`` (each as ``_hit`` gives them)."""
    act = rec["state"].active
    miss_r, miss_g = ref["t"] >= nqr.INF_CUT, got["t"] >= nqr.INF_CUT
    same = (miss_r == miss_g) & (miss_r | (ref["tri"] == got["tri"]))
    share = float((act & ~same).sum()) / max(int(act.sum()), 1)
    both = act & same & ~miss_r
    surf = both & (ref["tri"] < n_surfaces)
    surv = surf & (rec["state"].bounce + 1 < max_bounces)
    pairs = [("t", both, slice(None)), ("mrow", both, slice(0, 3)),
             ("mrow", both, slice(3, 11)), ("qpos", surf, slice(None)),
             ("o", surv, slice(None)), ("d", surv, slice(None))]
    return max([share] + [_rel_max(got[k][m][..., c], ref[k][m][..., c])
                          for k, m, c in pairs])


def train_gap(rec, sizes, verts, kw: dict, low=None) -> float:
    """``train_gap`` of one record: each minibatch's Adam step taken by
    the reference from the program's state before it (``before``, then
    ``trained``), against the program's state after it (with ``low``,
    the reference's step in that dtype stands in for the program's):
    the norm of the parameters' gaps over every minibatch over the norm
    of the reference's changes; 1 where a step count differs or a
    minibatch's state is missing."""
    st = rec["state"]
    action, td = torch.clamp(st.action, min=0), rec["td"]
    w = rec["pending"].float()
    rows = st.prev_loc.shape[0]
    b = min(kw["batch"], rows)
    starts = range(0, rows, b)
    states = [rec["before"]] + rec["trained"]
    if len(states) != len(starts) + 1:
        return 1.0
    n = nqr.n_params(sizes)
    gap2 = change2 = 0.0
    for j, s in enumerate(starts):
        flat = states[j][0]
        args = ({"flat": flat, "count": states[j][1]}, sizes, verts,
                st.prev_loc[s:s + b], action[s:s + b], td[s:s + b],
                w[s:s + b])
        ref = nqr.train(*args, **kw)
        got = (nqr.train(*args, ft=low, **kw) if low is not None else
               {"flat": states[j + 1][0], "count": int(states[j + 1][1])})
        if got["count"] != ref["count"]:
            return 1.0
        gap2 += float((got["flat"][:n] - ref["flat"][:n]).norm()) ** 2
        change2 += float((ref["flat"][:n] - flat[:n]).norm()) ** 2
    return math.sqrt(gap2) / max(math.sqrt(change2), 1e-30)


def last_live(cap):
    """The capture's last record with a live slot (None if none)."""
    for rec in reversed(cap.tail_records):
        if bool(rec["live"]):
            return rec
    return None


def check(run, kept, control: bool = False):
    """Compare the kept frames with the reference, stage by stage.  With
    ``control``, the reference computed in bfloat16 stands in the
    program's place (the same inputs, the same comparisons)."""
    c, t = run.config, run.traffic
    d, dev = c["deep"], run.device
    low = common.CONTROL_DTYPE
    drawn, last = kept["drawn"], kept["last"]
    frames = drawn if any(f is last for f in drawn) else drawn + [last]
    run.extra["checked"] = []    # [frame, step, width] a record checked
    tables = common.scene_module(c).reference_tables(c)
    packed, packed_low = tables.packed(dev), tables.packed(dev, low)
    verts = torch.as_tensor(nqr.vertices_flat(tables), device=dev)
    sizes = run.extra["deep"]["sizes"]
    n = nqr.n_params(sizes)
    grid, ns = d["sector_grid"], tables.n_surfaces
    n_pix = c["width"] * c["height"]
    kw = dict(batch=d["batch_size"], lr=d["learning_rate"], b1=d["adam_b1"],
              b2=d["adam_b2"], eps=d["adam_eps"])
    out = dict.fromkeys(GAPS, 0.0)

    def keep_max(name, value):
        if value != value:        # NaN: as far off as a reading can be
            value = NAN_GAP
        out[name] = max(out[name], value)

    for f in frames:
        cap = f["cap"]
        recs = []
        if any(f is g for g in drawn):
            recs.append(next(iter(cap.records.values()), None)
                        or last_live(cap))
        if f is last:
            recs.append(last_live(cap))
        for rec in (r for r in recs if r is not None):
            run.extra["checked"].append([f["index"], rec["step"],
                                         rec["width"]])
            st = rec["state"]
            act = st.active
            qs, u = rec["qs"], rec["u"]
            normal, lum = rec["mrow"][:, 0:3], rec["mrow"][:, 10]
            sec_ref, pdf_ref, _ = nqr.sample(qs, u, normal, rec["eps"], grid)

            rays = (st.o, st.d)
            h_ref = _hit(*rays, *packed, sec_ref, u, grid, c["eps"])
            o = rec["out"]
            h_got = (_hit(*rays, *packed_low, sec_ref, u, grid, c["eps"])
                     if control else
                     {"t": rec["t"], "tri": rec["tri"].long(),
                      "mrow": rec["mrow"], "qpos": rec["qpos"], "o": o.o,
                      "d": o.d})
            keep_max("hit_gap", hit_gap(rec, h_ref, h_got, ns,
                                        c["max_ray_bounces"]))

            missed, light, surf = nqr.hit_masks(act, rec["t"], rec["tri"],
                                                ns)
            layers = nqr.layers_from_flat(rec["before"][0][:n], sizes)
            pos = rec["qpos"][surf]
            q_ref = nqr.q_values(layers, verts, pos)
            q_got = (nqr.q_values(layers, verts, pos, low) if control
                     else rec["qs"][surf])
            keep_max("q_gap", _rel_max(q_got, q_ref))

            sec_got = (nqr.sample(qs, u, normal, rec["eps"], grid, low)[0]
                       if control else rec["sector"])
            if bool(surf.any()):
                keep_max("sector_gap", float(
                    (sec_got[surf] != sec_ref[surf]).double().mean()))

            scale = d["light_reward_scale"]
            td_ref = nqr.td_targets(qs, lum, light, surf, scale, grid)
            td_got = (nqr.td_targets(qs, lum, light, surf, scale, grid, low)
                      if control else rec["td"])
            keep_max("td_gap", _rel_max(td_got[act], td_ref[act]))

            keep_max("train_gap", train_gap(rec, sizes, verts, kw,
                                            low if control else None))

            sdict = st._asdict()
            tr = (c["environment_light"], c["max_ray_bounces"], grid)
            slot, srad, tp, surv = nqr.transport(
                sdict, rec["t"], rec["tri"], rec["mrow"], sec_ref, u,
                pdf_ref, ns, *tr)
            if control:
                g_slot, g_srad, g_tp, _ = nqr.transport(
                    sdict, rec["t"], rec["tri"], rec["mrow"], sec_ref, u,
                    pdf_ref, ns, *tr, ft=low)
            else:
                g_slot, g_srad, g_tp = o.slot_rad, o.sample_rad, o.tp
            keep_max("rad_gap", max(_rel_l1(g_slot, slot),
                                    _rel_l1(g_tp[surv], tp[surv]),
                                    _rel_l1(g_srad[surv], srad[surv])))

        ref_img = nqr.assemble(cap.flushes, n_pix, cap.w0, t["spp"])
        got_img = (nqr.assemble(cap.flushes, n_pix, cap.w0, t["spp"], low)
                   if control else f["img"].reshape(-1, 3))
        keep_max("img_gap", _rel_l1(got_img, ref_img))
    return common.judge(run, out)
