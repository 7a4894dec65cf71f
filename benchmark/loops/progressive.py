"""Progressive rendering, as the engine's viewer runs it: one client asks
for a frame of ``spp`` samples a pixel through ``render_default_mega``,
adds it to a running image on the device, waits for the device, and asks
for the next.  Every frame of the window is timed from its call to the
end of its synchronisation.

The comparison: ``check_frames`` frames drawn from the seed evenly over
the whole window, and the window's last frame, are traced again by the
reference, each over as many pixels, drawn from the seed, as keep the
reference's ray-triangle tests near ``check_pairs`` (every pixel where
that allows).  A pixel is a slot of its own, and slots never interact in
a frame, so the reference's pixels are the frame's.
``img_gap`` is sum |program - reference| / sum |reference| over those
pixels; ``path_gap`` the relative gap between the frame's mean path length
and the reference's mean over its slots (exact when every slot is traced,
a sample's estimate otherwise).
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
    from rlrpt_tpu_torch.ops.megakernel import render_default_mega
    c, t = run.config, run.traffic
    scene_mod = common.scene_module(c)
    scene = scene_mod.program_scene(c, run.device)
    run.mark("scene")
    camera = Camera.create(c["camera"])
    cfg = RenderConfig(width=c["width"], height=c["height"],
                       samples_per_pixel=t["spp"],
                       max_ray_bounces=c["max_ray_bounces"],
                       environment_light=c["environment_light"],
                       eps=c["eps"], russian_roulette=c["russian_roulette"])
    run.paths_per_answer = cfg.n_pixels * cfg.samples_per_pixel
    run.extra.update(n_tris=scene.n_triangles, n_slots=common.n_slots(c),
                     kernel_segments=[])
    state = {"scene": scene, "camera": camera, "cfg": cfg,
             "render": common.faulty(render_default_mega, "render", run)}
    warm = random.Random(run.seed ^ 0x5EED)
    acc = torch.zeros((cfg.height, cfg.width, 3), device=run.device)
    seg = common.SegmentLog(run.device, t["warmup_frames"])
    for _ in range(t["warmup_frames"]):   # the window's calls, in its order
        s = warm.randrange(0, 2 ** 31 - 1)
        img, aux = state["render"](s, scene, camera, cfg, run.device)
        acc += img
        seg.add(aux["avg_path_length"])
        common.synchronize(run.device)
    run.mark("warmup")
    return state


def window(run, state):
    t = run.traffic
    scene, camera, cfg = state["scene"], state["camera"], state["cfg"]
    render, dev = state["render"], run.device
    seeds = random.Random(run.rng.randrange(2 ** 62))
    sample = common.Sample(run.rng, t["check_frames"])
    seg = common.SegmentLog(dev)
    acc = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    span = run.spans.span
    with common.Window(run) as w:
        while w.open():
            i = run.answers
            s = seeds.randrange(0, 2 ** 31 - 1)
            t0 = time.perf_counter()
            with span("frame"):
                with span("render_default_mega"):
                    img, aux = render(s, scene, camera, cfg, dev)
                with span("accumulate"):
                    acc += img
                    seg.add(aux["avg_path_length"])
                with span("sync"):
                    common.synchronize(dev)
            w.answer(time.perf_counter() - t0)
            sample.offer((i, s, img, aux))
    run.extra["kernel_segments"] = [
        a * run.paths_per_answer for a in seg.values()]
    return {"frames": sample.kept(), "image": acc}


def check(run, kept, control: bool = False):
    """Compare the kept frames with the reference.  With ``control``, the
    reference computed in bfloat16 stands in the program's place."""
    c, t = run.config, run.traffic
    dev = run.device
    tables = common.scene_module(c).reference_tables(c)
    tris, mat = tables.packed(dev)
    low = tables.packed(dev, common.CONTROL_DTYPE)
    fr = common.frame(c, t["spp"])
    n_slots, cam = common.n_slots(c), common.camera(c)
    out = {"img_gap": 0.0, "path_gap": 0.0}
    run.extra["checked"] = [f[0] for f in kept["frames"]]
    for _, s, img, aux in kept["frames"]:
        pix = common.draw_slots(run.rng, fr.n_pix, common.check_pixels(
            t["check_pairs"], run.extra["n_tris"], fr), dev)
        rad, path_sum, _ = pt.render(s, cam, tris, mat, fr, n_slots,
                                     common.PIX_MUX, pix)
        ref_len = float(path_sum.double().sum()) / (pix.shape[0] * fr.spp)
        if control:
            rad_c, ps_c, _ = pt.render(s, cam, *low, fr, n_slots,
                                       common.PIX_MUX, pix)
            got = rad_c[0] / fr.spp
            got_len = float(ps_c.double().sum()) / (pix.shape[0] * fr.spp)
        else:
            got = img.reshape(-1, 3)[pix]
            got_len = float(aux["avg_path_length"])
        out["img_gap"] = max(out["img_gap"], imagecmp.rel_l1(
            got.double().cpu().numpy(),
            (rad[0] / fr.spp).double().cpu().numpy()))
        out["path_gap"] = max(out["path_gap"],
                              imagecmp.rel_gap(got_len, ref_len))
    return common.judge(run, out)
