"""The program's own tracing on the card (``-m chip``; each test skips
without one): every host wait on the learning job's and the render's
paths is one that the program counts, site for site, against torch's sync
debug mode; the timed B2 (its phase clock) renders and learns what the
plain one does, and its phases add up to each block's cycles.  The CPU
half is tests/test_torch_tracing.py."""

import collections
import warnings
from pathlib import Path

import pytest
import torch

# the file of each counted host wait (the frame torch names in its warning)
SITES = {"hemisphere.py": "up_vector", "guided_mega.py": "check_cdf",
         "bvh.py": "bvh_info", "megakernel.py": "walk_counts"}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _learning_job(dev, scene, seed, cfg, guided_cfg):
    """The benchmark's learning job (benchmark/loops/learning_jobs.py) on
    the Cornell box ``scene`` at ``cfg``: a fresh table, 10 learning frames
    each followed by a rebuild, a guided render.  Returns the learning
    frames' iteration counts."""
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import RadianceVolumeConfig
    from rlrpt_tpu_torch.ops import guided_mega as gm
    from rlrpt_tpu_torch.ops import guided_mega_train as gt
    rl = RadianceVolumeConfig(grid_resolution=11)
    cam = Camera.create([0.0, 0.0, -3.0])
    q, v = gt.init_bin_q(40, 4, 11, rl.initial_radiance, device=dev)
    table = gt.rebuild_bin_cdf(q, 11, 4, 40)
    iterations = []
    for f in range(10):
        _, q, v, aux = gt.render_sarsa_mega_train(
            seed + f, scene, cam, table, q, v, cfg, rl.radiance_threshold,
            dev)
        iterations.append(aux["wavefront_iterations"])
        table = gt.rebuild_bin_cdf(q, 11, 4, 40)
    gm.render_guided_mega(seed + 10, scene, cam, table, guided_cfg, dev)
    return iterations


@pytest.mark.chip
def test_every_host_wait_is_counted(tmp_path):
    dev = _card()
    from torch.profiler import ProfilerActivity, profile

    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import RenderConfig
    from rlrpt_tpu_torch.ops import bvh as bv
    from rlrpt_tpu_torch.ops import guided_mega_train as gt
    from rlrpt_tpu_torch.ops import megakernel as mk
    from rlrpt_tpu_torch.scene import cornell_box, generated
    from rlrpt_tpu_torch.utils import profiling
    cfg = RenderConfig(width=128, height=128, samples_per_pixel=4,
                       max_ray_bounces=80)
    cam = Camera.create([0.0, 0.0, -3.0])
    # the scenes' copies to the card are set-up, outside the paths
    cornell = cornell_box(device=dev)
    torus = generated.torus_room(tmp_path / "torus.obj", 12, 12).load(
        device=dev)

    def paths():
        """One learning job; one frame of Cornell (the sweep) and of the
        torus (culled: a tree built on the card); the walk's counts."""
        paths.iterations = _learning_job(dev, cornell, 11, cfg, cfg)
        job = sum(profiling.RECORDER.syncs.values())
        mk.render_default_mega(3, cornell, cam, cfg, dev)
        mk.render_default_mega(3, torus, cam, cfg, dev)
        tris, mat = mk.pack_scene(torus)
        mk.walk_counts(4, mk.camera_vector(cam), tris, mat, cfg,
                       mk.n_slots_for(cfg.n_pixels, 128, 1), 1,
                       bv.build_bvh(tris))
        return job

    paths()   # the library's build and every first call, unrecorded
    torch.cuda.synchronize()
    profiling.RECORDER.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                job = paths()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    seen = collections.Counter(
        SITES.get(Path(w.filename).name, f"{w.filename}:{w.lineno}")
        for w in caught if "synchroniz" in str(w.message))
    counted = collections.Counter(profiling.RECORDER.syncs)
    print(f"host waits: torch's sync debug mode {dict(seen)}, counted "
          f"{dict(counted)}; {job} in the learning job")
    # the timed B2 ran every learning frame into one clock buffer
    rows = gt.train_blocks(mk.n_slots_for(cfg.n_pixels, 128, 1), dev)
    clock = profiling.RECORDER.b2_clock.tolist()
    profiling.RECORDER.reset()
    assert seen == counted
    assert set(counted) == set(SITES.values())
    it = profiling.CLOCK_COLS.index("iterations")
    assert len(clock) == rows
    assert sum(r[it] for r in clock) == rows * sum(
        int(i) for i in paths.iterations)


@pytest.mark.chip
def test_timed_b2_is_the_plain_one():
    dev = _card()
    from rlrpt_tpu_torch.camera import Camera
    from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
    from rlrpt_tpu_torch.ops import guided_mega_train as gt
    from rlrpt_tpu_torch.ops import hemisphere as hs
    from rlrpt_tpu_torch.ops import megakernel as mk
    from rlrpt_tpu_torch.scene import cornell_box
    from rlrpt_tpu_torch.utils import profiling
    rl = RadianceVolumeConfig(grid_resolution=11)
    cfg = RenderConfig(width=256, height=256, samples_per_pixel=8,
                       max_ray_bounces=80)
    scene = cornell_box(device=dev)
    tris, mat = mk.pack_scene(scene)
    q, v = gt.init_bin_q(40, 4, 11, rl.initial_radiance, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(5)
    q[:121] *= 0.5 + torch.rand(q[:121].shape, generator=gen).to(dev)
    cdf_t = gt.rebuild_bin_cdf(q, 11, 4, 40).cdf.T.contiguous()
    n_slots = mk.n_slots_for(cfg.n_pixels, 128, 1)
    args = (9, mk.camera_vector(Camera.create([0.0, 0.0, -3.0])), tris, mat,
            cdf_t, gt.bin_luminance(scene, 40, 4)[0],
            hs.sector_cos_thetas(11, dev).contiguous(), q, v, 11, 4,
            rl.radiance_threshold, cfg, n_slots, 1)
    rows = gt.train_blocks(n_slots, dev)
    clock = torch.zeros((rows, len(profiling.CLOCK_COLS)),
                        dtype=torch.int64, device=dev)
    before = (gt.KERNEL.launches, gt.KERNEL_TIMED.launches)
    plain = gt.mega_train_frame(*args)
    plain2 = gt.mega_train_frame(*args)
    timed = gt.mega_train_frame(*args, clock=clock)
    assert (gt.KERNEL.launches, gt.KERNEL_TIMED.launches) == (
        before[0] + 2, before[1] + 1)
    names = ("rad", "path_sum", "iters", "q", "visits", "td")
    for name, a, b in zip(names, plain, timed):
        if name != "q":
            assert torch.equal(a, b), name
    # Q takes its TD targets by atomicAdd, so its last bits follow the
    # order of the adds, plain against plain as well
    gap = float((plain[3] - timed[3]).abs().max() / plain[3].abs().max())
    gap_plain = float((plain[3] - plain2[3]).abs().max()
                      / plain[3].abs().max())
    print(f"Q's largest change over its largest value: timed {gap:.3e}, "
          f"plain against plain {gap_plain:.3e}")
    assert gap < 1e-5

    c = clock.cpu()
    cols = {n: c[:, i] for i, n in enumerate(profiling.CLOCK_COLS)}
    parts = sum(cols[n] for n in ("start", "step", "wait1", "apply",
                                  "wait2"))
    assert bool((cols["total"] > 0).all())
    assert float(((parts - cols["total"]).abs()
                  / cols["total"]).max()) < 0.01
    assert bool((cols["iterations"] == int(timed[2].max())).all())
    total = float(cols["total"].sum())
    mean = {n: round(100 * float(cols[n].sum()) / total, 2)
            for n in profiling.CLOCK_COLS[:5]}
    shares = {n: round(v, 2) for n, v in profiling.b2_shares(clock).items()}
    applying = int((2 * cols["apply"] >= cols["apply"].max()).sum())
    print(f"B2 at 256x256, 8 spp, {rows} blocks: {mean} % of all blocks' "
          f"cycles; {shares} % of the {applying} that apply")
