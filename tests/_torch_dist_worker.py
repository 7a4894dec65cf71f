"""Rank functions of the torch.distributed tests (not a test module).

``rlrpt_tpu_torch.parallel.multihost.spawn`` runs ``run`` in each spawned
process, which re-imports this module there: so it imports no JAX.  Each
rank forms a gloo group on the CPU, builds its inputs from the numpy
payload (or from the port's own deterministic constructors), calls one case
and returns numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import DeepLearningConfig, RadianceVolumeConfig
from rlrpt_tpu_torch.nn.adam import adam_init
from rlrpt_tpu_torch.parallel import dp, multihost, multiscene
from rlrpt_tpu_torch.parallel.mesh import make_mesh
from rlrpt_tpu_torch.radiance.grid_bucket import build_volume_class_table
from rlrpt_tpu_torch.radiance.volumes import build_radiance_volumes
from rlrpt_tpu_torch.scene import cornell_box, presets
from rlrpt_tpu_torch.utils.convert import (dq_network_from_numpy,
                                           tri_bin_cdf_from_numpy)

CAM = (0.0, 0.0, -3.0)


def run(rank: int, world: int, address: str, case: str, payload: dict):
    torch.set_num_threads(1)
    multihost.initialize(address, world, rank, device="cpu")
    try:
        return CASES[case](make_mesh(device="cpu"), **payload)
    finally:
        dist.destroy_process_group()


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _net_out(net, opt):
    return {"params": [_np(p) for p in net.parameters()],
            "count": int(opt.count), "mu": [_np(m) for m in opt.mu],
            "nu": [_np(v) for v in opt.nu]}


def _vols(area_per_sample, q=None, visits=None):
    scene = cornell_box(device="cpu")
    rl = RadianceVolumeConfig(area_per_sample=area_per_sample)
    vols = build_radiance_volumes(scene, rl)
    if q is not None:
        vols = dataclasses.replace(vols, q=torch.from_numpy(q),
                                   visits=torch.from_numpy(visits))
    return scene, rl, vols


# ---- the hooks ------------------------------------------------------------

def sarsa_update(mesh, q, visits, vol_idx, sector, target, mask, thr,
                 area_per_sample):
    """expected_sarsa_update on this rank's half of the contributions."""
    from rlrpt_tpu_torch.radiance.volumes import expected_sarsa_update
    _, _, vols = _vols(area_per_sample, q, visits)
    half = len(vol_idx) // mesh.size
    sl = slice(mesh.rank * half, (mesh.rank + 1) * half)
    t = lambda a: torch.from_numpy(a[sl])  # noqa: E731
    out = expected_sarsa_update(vols, t(vol_idx), t(sector), t(target),
                                t(mask), thr, mesh=mesh)
    return {"q": _np(out.q), "visits": _np(out.visits)}


def train_batches(mesh, layers, prev_loc, actions, tds, weights, batch_size,
                  steps):
    """train_on_batches on this rank's half of every global minibatch of
    ``batch_size`` rays, ``steps`` times over."""
    from rlrpt_tpu_torch.deep.neural_q import train_on_batches
    net = dq_network_from_numpy(layers)
    opt = adam_init(net.parameters())
    b = batch_size // mesh.size
    rows = np.concatenate([np.arange(s + mesh.rank * b, s + (mesh.rank + 1)
                                     * b)
                           for s in range(0, len(tds), batch_size)])
    t = lambda a: torch.from_numpy(a[rows])  # noqa: E731
    dl = DeepLearningConfig(batch_size=b, hidden_sizes=())
    losses = [_np(train_on_batches(net, opt, cornell_box(device="cpu"),
                                   t(prev_loc), t(actions), t(tds), dl,
                                   weights=t(weights), mesh=mesh))
              for _ in range(steps)]
    return {**_net_out(net, opt), "loss": losses}


def uneven_sarsa(mesh, cfg, yaw_x, pix_mux):
    """The SARSA wavefront's hook on two equal shards of a frame whose
    halves carry unequal work; returns the rank's own live iterations."""
    from rlrpt_tpu_torch.integrators.sarsa_wavefront import \
        trace_frame_sarsa_wavefront
    from rlrpt_tpu_torch.parallel.mesh import rank_seed, shard_range
    scene, rl, vols = _vols(0.05)
    table = build_volume_class_table(vols, scene)
    lo, n_local = shard_range(cfg.n_pixels, mesh)
    img, vols2, _, _, iters, td, _, _ = trace_frame_sarsa_wavefront(
        rank_seed(3, mesh.rank), scene, Camera.create(CAM, yaw_x=yaw_x),
        vols, table, cfg, rl, pix_mux=pix_mux, mesh=mesh, pix_lo=lo,
        n_pix_local=n_local)
    return {"img": _np(img), "iters": int(iters), "q": _np(vols2.q),
            "visits": _np(vols2.visits), "td": int(td)}


def uneven_deep(mesh, cfg, yaw_x, layers, dl):
    """The deep wavefront's training hook on two equal shards of that
    frame."""
    from rlrpt_tpu_torch.deep.deep_wavefront import \
        trace_frame_deep_wavefront
    from rlrpt_tpu_torch.parallel.mesh import rank_seed, shard_range
    net = dq_network_from_numpy(layers)
    opt = adam_init(net.parameters())
    lo, n_local = shard_range(cfg.n_pixels, mesh)
    img, stats = trace_frame_deep_wavefront(
        rank_seed(5, mesh.rank), cornell_box(device="cpu"),
        Camera.create(CAM, yaw_x=yaw_x), net, cfg,
        RadianceVolumeConfig(grid_resolution=6), dl, opt_state=opt,
        epsilon=0.3, train=True, pix_mux=2, pix_lo=lo, n_pix_local=n_local,
        mesh=mesh)
    return {"img": _np(img), "iters": int(stats["phase_iterations"].sum()),
            **_net_out(net, opt)}


# ---- the dp entry points ---------------------------------------------------

def default(mesh, seed, cfg):
    img, aux = dp.render_default_dp(seed, cornell_box(device="cpu"),
                                    Camera.create(CAM), cfg, mesh)
    return {"img": _np(img), "avg_path": aux["avg_path_length"]}


def sarsa_lockstep(mesh, seed, cfg, area_per_sample):
    scene, rl, vols = _vols(area_per_sample)
    img, vols2, aux = dp.render_frame_sarsa_dp(seed, scene,
                                               Camera.create(CAM), vols, cfg,
                                               rl, mesh)
    return {"img": _np(img), "q0": _np(vols.q), "q": _np(vols2.q),
            "visits": _np(vols2.visits), "cdf": _np(vols2.cdf),
            "td": int(aux["td_scatter_count"])}


def sarsa_wavefront(mesh, seed, cfg, area_per_sample):
    scene, rl, vols = _vols(area_per_sample)
    table = build_volume_class_table(vols, scene)
    img, vols2, aux = dp.render_frame_sarsa_wavefront_dp(
        seed, scene, Camera.create(CAM), vols, table, cfg, rl, mesh)
    return {"img": _np(img), "q": _np(vols2.q), "visits": _np(vols2.visits),
            "td": int(aux["td_scatter_count"]),
            "avg_path": float(aux["avg_path_length"])}


def nq_step(mesh, seed, cfg, layers, dl, epsilon, use_pallas):
    net = dq_network_from_numpy(layers)
    opt = adam_init(net.parameters())
    tp, net, opt, loss = dp.neural_q_train_step_dp(
        seed, cornell_box(device="cpu"), Camera.create(CAM), net, opt,
        epsilon, cfg, RadianceVolumeConfig(grid_resolution=6), dl, mesh,
        use_pallas=use_pallas)
    return {"tp": _np(tp), "loss": float(loss), **_net_out(net, opt)}


def pretrained(mesh, seed, cfg, layers, dl):
    img, aux = dp.render_frame_pretrained_wavefront_dp(
        seed, cornell_box(device="cpu"), Camera.create(CAM),
        dq_network_from_numpy(layers), cfg,
        RadianceVolumeConfig(grid_resolution=6), dl, mesh)
    return {"img": _np(img), "avg_path": float(aux["avg_path_length"])}


def nq_wavefront(mesh, seed, cfg, layers, dl, epsilon):
    net = dq_network_from_numpy(layers)
    opt = adam_init(net.parameters())
    img, net, opt, eps, aux = dp.render_frame_neural_q_wavefront_dp(
        seed, cornell_box(device="cpu"), Camera.create(CAM), net, opt,
        epsilon, cfg, RadianceVolumeConfig(grid_resolution=6), dl, mesh)
    return {"img": _np(img), "eps": eps, "loss": float(aux["loss"]),
            **_net_out(net, opt)}


def _table(cdf, sector_grid, uv_bins, t_pad):
    return tri_bin_cdf_from_numpy(cdf, sector_grid, uv_bins, t_pad)


def guided(mesh, seeds, cfg, cdf, sector_grid, uv_bins, t_pad, r_tile,
           pix_mux):
    img, aux = dp.render_guided_mega_dp(
        seeds, cornell_box(device="cpu"), Camera.create(CAM),
        _table(cdf, sector_grid, uv_bins, t_pad), cfg, mesh,
        pix_mux=pix_mux, r_tile=r_tile)
    return {"img": _np(img), "avg_path": float(aux["avg_path_length"])}


def sarsa_mega(mesh, seeds, cfg, cdf, q, visits, thr, sector_grid, uv_bins,
               t_pad, r_tile, pix_mux):
    img, q1, v1, aux = dp.sarsa_mega_train_dp(
        seeds, cornell_box(device="cpu"), Camera.create(CAM),
        _table(cdf, sector_grid, uv_bins, t_pad), torch.from_numpy(q),
        torch.from_numpy(visits), cfg, thr, mesh, pix_mux=pix_mux,
        r_tile=r_tile)
    return {"img": _np(img), "q": _np(q1), "visits": _np(v1),
            "td": int(aux["td_scatter_count"])}


def spp_check(mesh, cfg, cdf, sector_grid, uv_bins, t_pad):
    """Both megakernel entry points refuse an spp the world size does not
    divide; returns their messages."""
    table = _table(cdf, sector_grid, uv_bins, t_pad)
    scene, cam = cornell_box(device="cpu"), Camera.create(CAM)
    msgs = []
    for call in (lambda: dp.render_guided_mega_dp(3, scene, cam, table, cfg,
                                                  mesh),
                 lambda: dp.sarsa_mega_train_dp(
                     3, scene, cam, table, torch.zeros(1),
                     torch.zeros(1), cfg, 0.0, mesh)):
        try:
            call()
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return msgs


# ---- multiscene and multihost ---------------------------------------------

def _two_scenes():
    scenes, cams = [], []
    for name in ("cornell", "test_room"):
        p = presets.get(name)
        scenes.append(p.load(device="cpu"))
        cams.append(Camera.create(p.camera_position))
    return scenes, cams


def multiscene_render(mesh, seed, cfg):
    scenes, cams = _two_scenes()
    return {"imgs": _np(multiscene.render_multiscene_dp(seed, scenes, cams,
                                                        cfg, mesh))}


def multiscene_train(mesh, seed, cfg, dl, epsilon):
    scenes, cams = _two_scenes()
    rl = RadianceVolumeConfig(grid_resolution=6)
    net, opt, batched = multiscene.init_multiscene_neural_q(
        5, scenes, dl, rl.grid_resolution, device="cpu")
    p0 = [_np(p).copy() for p in net.parameters()]
    imgs, net, opt, eps, aux = multiscene.train_multiscene_deep_dp(
        seed, scenes, cams, net, opt, epsilon, cfg, rl, dl, mesh,
        batched=batched)
    return {"imgs": _np(imgs), "p0": p0, "eps": eps,
            "loss": float(aux["loss"]),
            "zclp": _np(aux["zero_contribution_light_paths"]),
            **_net_out(net, opt)}


def assemble(mesh, seed, cfg):
    """render_default_dp, then each rank's rows of it assembled back."""
    img, _ = dp.render_default_dp(seed, cornell_box(device="cpu"),
                                  Camera.create(CAM), cfg, mesh)
    rows = multihost.host_local_slice(cfg.height, mesh)
    return {"img": _np(img),
            "assembled": _np(multihost.assemble_image(img[rows], mesh)),
            "rows": (rows.start, rows.stop)}


CASES = {f.__name__: f for f in (
    sarsa_update, train_batches, uneven_sarsa, uneven_deep, default,
    sarsa_lockstep, sarsa_wavefront, nq_step, pretrained, nq_wavefront,
    guided, sarsa_mega, spp_check, multiscene_render, multiscene_train,
    assemble)}


def fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return "done"


def hang_on_rank_1(mesh):
    import time
    if mesh.rank == 1:
        time.sleep(300)
    return "done"


CASES.update({f.__name__: f for f in (fail_on_rank_1, hang_on_rank_1)})
