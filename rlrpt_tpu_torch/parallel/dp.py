"""Data-parallel sharded renderers and training steps (counterpart of
``rlrpt_tpu/parallel/dp.py``).

One process per rank (parallel.mesh).  The mapping is the JAX module's:

* rays and pixels shard over the ranks, each rank holding an equal,
  contiguous share (the lockstep paths pad the ray list to a multiple of
  the world size, as ``_padded_rays`` there);
* the scene, the Q tables, the net and its Adam state replicate;
* per-bounce (lockstep) or per-iteration (wavefront) Q-table
  contributions and per-minibatch DQN gradients are psum'd before the
  update, so every rank applies one identical update and the replicated
  state stays bit-identical with no resharding;
* every host decision that sets how many collectives a rank issues (a
  bounce loop's exit, a drain phase's end) is taken on a value reduced
  over the ranks, so all ranks run the same trips (JAX psums its
  while_loop conditions for the same reason).

Seeds.  The JAX functions take a key and fold each device's index into
it.  Here the entry points take an int ``seed``: rank r draws its rays'
randomness from ``rank_seed(seed, r)`` (the seed of a torch.Generator on
the torch-loop paths, the kernel's int seed on B2 and B3), and draws that
must agree across ranks (the full-frame camera jitter of the lockstep
paths, JAX's unfolded camera key) from ``seed`` itself.  The two
megakernel entry points also take a sequence of per-rank seeds, one a
rank.  Every rank returns what the JAX function returns: the whole image
and the replicated state.

Kernels on these paths (the card; CPU tensors take the plain twins):
``render_frame_sarsa_dp`` B4b; ``render_frame_sarsa_wavefront_dp``, the
two deep wavefronts and ``neural_q_train_step_dp`` (``use_pallas``) B4a;
``render_guided_mega_dp`` B3; ``sarsa_mega_train_dp`` B2.
``render_default_dp`` traces with the plain ``ops.intersect`` sweep, as
the JAX one takes the XLA default tracer.
"""

from __future__ import annotations

import dataclasses

import torch

from rlrpt_tpu_torch.camera import Camera, primary_rays
from rlrpt_tpu_torch.config import (DeepLearningConfig, RadianceVolumeConfig,
                                    RenderConfig)
from rlrpt_tpu_torch.deep import neural_q as nq
from rlrpt_tpu_torch.deep.deep_wavefront import trace_frame_deep_wavefront
from rlrpt_tpu_torch.integrators.default_tracer import trace_sample
from rlrpt_tpu_torch.integrators.reinforcement_tracer import \
    trace_sample_sarsa
from rlrpt_tpu_torch.integrators.sarsa_wavefront import \
    trace_frame_sarsa_wavefront
from rlrpt_tpu_torch.nn.adam import AdamState
from rlrpt_tpu_torch.nn.dq_network import DQNetwork
from rlrpt_tpu_torch.ops.bvh import build_bvh
from rlrpt_tpu_torch.ops.guided_mega import render_guided_mega
from rlrpt_tpu_torch.ops.guided_mega_train import render_sarsa_mega_train
from rlrpt_tpu_torch.ops.intersect_pallas import pack_triangles
from rlrpt_tpu_torch.ops.megakernel import PIX_MUX, R_TILE
from rlrpt_tpu_torch.parallel.mesh import (Mesh, all_gather, make_mesh,
                                           pad_to_multiple, psum, rank_seed,
                                           ray_specs, seed_of_rank,
                                           shard_range)
from rlrpt_tpu_torch.radiance.bake import TriBinCDF
from rlrpt_tpu_torch.radiance.volumes import (RadianceVolumes, rebuild_cdf,
                                              td_scratch)
from rlrpt_tpu_torch.scene.scene import Scene


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _padded_rays(generator, camera: Camera, cfg: RenderConfig, world: int):
    """Primary rays for the full frame, padded to a multiple of the world
    size with copies of the last ray (their results are dropped).
    Returns (o, d, n_rays)."""
    o, d = primary_rays(generator, camera, cfg.width, cfg.height, cfg.focal)
    r = o.shape[0]
    pad = pad_to_multiple(r, world) - r
    if pad:
        o = torch.cat([o, o[-1:].expand(pad, 3)])
        d = torch.cat([d, d[-1:].expand(pad, 3)])
    return o, d, r


def _sums(n: int, device):
    """Zeroed radiance (n, 3) and path-length (n,) accumulators."""
    return (torch.zeros((n, 3), dtype=torch.float32, device=device),
            torch.zeros((n,), dtype=torch.int64, device=device))


def _max_over_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return all_gather(x.reshape(1), mesh).max()


def _sum_over_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return psum(x.reshape(1).clone(), mesh)[0]


def _default_shard(seed: int, rank: int, world: int, scene: Scene,
                   camera: Camera, cfg: RenderConfig, device):
    """Rank ``rank``'s share of render_default_dp: its rays of each padded
    full-frame sample, traced with the rank's generator.  Returns the
    radiance and path-length sums over spp, (n_local, 3) and (n_local,).
    No collective: a world of one computes any rank's share."""
    mesh = Mesh(None, rank, world, torch.device(device))
    cam_gen = _generator(seed, device)
    gen = _generator(rank_seed(seed, rank), device)
    sl, _ = ray_specs(pad_to_multiple(cfg.n_pixels, world), mesh)
    acc, path = _sums(sl.stop - sl.start, device)
    for _ in range(cfg.samples_per_pixel):
        o, d, _ = _padded_rays(cam_gen, camera, cfg, world)
        rad, plen = trace_sample(gen, o[sl].contiguous(), d[sl].contiguous(),
                                 scene, cfg)
        acc, path = acc + rad, path + plen
    return acc, path


def render_default_dp(seed: int, scene: Scene, camera: Camera,
                      cfg: RenderConfig, mesh: Mesh | None = None):
    """Sharded default path trace; returns (image (H, W, 3), aux with
    avg_path_length, a float as render_default's).  The bounce loop has no
    cross-rank state, so each rank traces its ray shard independently: no
    collective until the image is gathered."""
    mesh = mesh or make_mesh()
    acc, path = _default_shard(seed, mesh.rank, mesh.size,
                               scene.to(mesh.device), camera, cfg,
                               mesh.device)
    n, spp = cfg.n_pixels, cfg.samples_per_pixel
    acc = all_gather(acc, mesh)[:n]
    path = all_gather(path, mesh)[:n]
    img = (acc / spp).reshape(cfg.height, cfg.width, 3)
    return img, {"avg_path_length": float(path.double().mean() / spp)}


def render_frame_sarsa_dp(seed: int, scene: Scene, camera: Camera,
                          vols: RadianceVolumes, cfg: RenderConfig,
                          rl: RadianceVolumeConfig, mesh: Mesh | None = None):
    """Sharded lockstep SARSA learning frame (hits on B4b); returns
    (image, volumes, aux).  The volumes stay replicated: each bounce's TD
    contributions are psum'd (radiance.volumes.expected_sarsa_update), so
    every rank applies one identical update.  The padded rays trace and
    learn as the JAX function's do; only the image drops them.  aux:
    avg_path_length, zero_contribution_light_paths, td_scatter_count (the
    visit-count delta)."""
    mesh = mesh or make_mesh()
    dev = mesh.device
    scene = scene.to(dev)
    tris = pack_triangles(scene)
    bvh = build_bvh(tris)
    scratch = td_scratch(vols.n_volumes, vols.n_sectors, dev)
    cam_gen = _generator(seed, dev)
    gen = _generator(rank_seed(seed, mesh.rank), dev)
    n, spp = cfg.n_pixels, cfg.samples_per_pixel
    sl, _ = ray_specs(pad_to_multiple(n, mesh.size), mesh)
    real = torch.arange(sl.start, sl.stop, device=dev) < n
    acc, path = _sums(sl.stop - sl.start, dev)
    zclp = td = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(spp):
        o, d, _ = _padded_rays(cam_gen, camera, cfg, mesh.size)
        rad, plen, vols, td_s = trace_sample_sarsa(
            gen, o[sl].contiguous(), d[sl].contiguous(), scene, vols, cfg,
            rl, tris, scratch, bvh, mesh=mesh)
        acc, path = acc + rad, path + plen
        zclp = zclp + (real & (rad.mean(-1) < cfg.throughput_threshold)).sum()
        td = td + td_s
    vols = rebuild_cdf(vols, rl.distribution_threshold, rl.defensive_mix)
    acc = all_gather(acc, mesh)[:n]
    path = all_gather(path, mesh)[:n]
    img = (acc / spp).reshape(cfg.height, cfg.width, 3)
    aux = {"avg_path_length": path.double().mean() / spp,
           "zero_contribution_light_paths": _sum_over_ranks(zclp, mesh),
           "td_scatter_count": td}
    return img, vols, aux


def render_frame_sarsa_wavefront_dp(seed: int, scene: Scene, camera: Camera,
                                    vols: RadianceVolumes, grid,
                                    cfg: RenderConfig,
                                    rl: RadianceVolumeConfig,
                                    mesh: Mesh | None = None,
                                    pix_mux: int = 4):
    """Sharded fast SARSA frame (regenerative wavefront on B4a, the
    nearest volume from ``grid``).  Rank r owns the pixels [r * n_local,
    (r + 1) * n_local) and its own wavefront; the per-iteration Q
    contributions are psum'd and the phase exits are taken on the ranks'
    reduced live counts (integrators.sarsa_wavefront.trace_frame_sarsa_
    wavefront).  Returns (image, volumes, aux) as render_frame_sarsa_
    wavefront: avg_path_length, zero_contribution_light_paths (psum'd),
    wavefront_iterations (the most any rank ran with a live slot),
    td_scatter_count (the visit-count delta)."""
    mesh = mesh or make_mesh()
    n_pix, spp = cfg.n_pixels, cfg.samples_per_pixel
    lo, n_local = shard_range(n_pix, mesh)
    img_sum, vols, path_sum, zclp, iters, td, _, _ = \
        trace_frame_sarsa_wavefront(
            rank_seed(seed, mesh.rank), scene, camera, vols, grid, cfg, rl,
            pix_mux=pix_mux, mesh=mesh, pix_lo=lo, n_pix_local=n_local)
    img_sum = all_gather(img_sum, mesh)[:n_pix]
    vols = rebuild_cdf(vols, rl.distribution_threshold, rl.defensive_mix)
    img = (img_sum / spp).reshape(cfg.height, cfg.width, 3)
    aux = {"avg_path_length": _sum_over_ranks(path_sum, mesh)
           / (n_pix * spp),
           "zero_contribution_light_paths": _sum_over_ranks(zclp, mesh),
           "wavefront_iterations": _max_over_ranks(iters, mesh),
           "td_scatter_count": td}
    return img, vols, aux


def neural_q_train_step_dp(seed: int, scene: Scene, camera: Camera,
                           net: DQNetwork, opt_state: AdamState, epsilon,
                           cfg: RenderConfig, rl: RadianceVolumeConfig,
                           dl: DeepLearningConfig, mesh: Mesh | None = None,
                           use_pallas: bool = True):
    """One sharded neural-Q training sample, lockstep: forward,
    epsilon-greedy trace (B4a, or the plain sweep with ``use_pallas``
    False), TD targets, per-minibatch psum'd gradients and the replicated
    Adam step.  Each rank holds 1/world of every global minibatch (the
    local batch is batch_size // world), so the update keeps the
    reference's global minibatch.  Returns (throughput (R, 3), net,
    opt_state, loss); the net and the state are updated in place."""
    mesh = mesh or make_mesh()
    dev = mesh.device
    scene = scene.to(dev)
    dl = dataclasses.replace(dl, batch_size=max(1, dl.batch_size
                                                // mesh.size))
    hit_fn = nq.make_hit_fn(scene, use_pallas, cfg.ray_tile)
    o, d, r = _padded_rays(_generator(seed, dev), camera, cfg, mesh.size)
    sl, _ = ray_specs(o.shape[0], mesh)
    state, loss = nq._trace_sample(
        _generator(rank_seed(seed, mesh.rank), dev), scene, camera, net,
        opt_state, epsilon, cfg, rl, dl, hit_fn,
        rays=(o[sl].contiguous(), d[sl].contiguous()), mesh=mesh)
    return all_gather(state.throughput, mesh)[:r], net, opt_state, loss


def _deep_aux(img_sum, stats: dict, cfg: RenderConfig, mesh: Mesh):
    n_pix, spp = cfg.n_pixels, cfg.samples_per_pixel
    img_sum = all_gather(img_sum, mesh)[:n_pix]
    img = (img_sum / spp).reshape(cfg.height, cfg.width, 3)
    aux = {"avg_path_length": _sum_over_ranks(stats["path_sum"], mesh)
           / (n_pix * spp),
           "zero_contribution_light_paths": _sum_over_ranks(stats["zclp"],
                                                            mesh),
           "wavefront_iterations": _max_over_ranks(
               stats["phase_iterations"].sum(), mesh)}
    return img, aux


def render_frame_pretrained_wavefront_dp(seed: int, scene: Scene,
                                         camera: Camera, net: DQNetwork,
                                         cfg: RenderConfig,
                                         rl: RadianceVolumeConfig,
                                         dl: DeepLearningConfig,
                                         mesh: Mesh | None = None,
                                         pix_mux: int = 4,
                                         mlp_dtype: str = "f32"):
    """Sharded regenerative pretrained render (frozen net, B4a).  Each
    rank owns a contiguous pixel range and its own wavefront; the only
    per-iteration collective is the phase-exit flag.  Returns (image, aux)
    with avg_path_length, zero_contribution_light_paths and
    wavefront_iterations."""
    mesh = mesh or make_mesh()
    lo, n_local = shard_range(cfg.n_pixels, mesh)
    img_sum, stats = trace_frame_deep_wavefront(
        rank_seed(seed, mesh.rank), scene, camera, net, cfg, rl, dl,
        train=False, pix_mux=pix_mux, mlp_dtype=mlp_dtype, pix_lo=lo,
        n_pix_local=n_local, mesh=mesh)
    return _deep_aux(img_sum, stats, cfg, mesh)


def render_frame_neural_q_wavefront_dp(seed: int, scene: Scene,
                                       camera: Camera, net: DQNetwork,
                                       opt_state: AdamState, epsilon,
                                       cfg: RenderConfig,
                                       rl: RadianceVolumeConfig,
                                       dl: DeepLearningConfig,
                                       mesh: Mesh | None = None,
                                       pix_mux: int = 4):
    """Sharded regenerative neural-Q training frame (B4a).  Per-minibatch
    gradients are psum'd before the replicated Adam step, and the local
    minibatch shrinks by the world size so the global one keeps the
    reference's size.  Returns (image, net, opt_state, epsilon advanced by
    spp decays (JAX's closed form), aux with avg_path_length, loss,
    zero_contribution_light_paths and wavefront_iterations); the net and
    the state are updated in place."""
    mesh = mesh or make_mesh()
    lo, n_local = shard_range(cfg.n_pixels, mesh)
    dl_local = dataclasses.replace(dl, batch_size=max(1, dl.batch_size
                                                      // mesh.size))
    img_sum, stats = trace_frame_deep_wavefront(
        rank_seed(seed, mesh.rank), scene, camera, net, cfg, rl, dl_local,
        opt_state=opt_state, epsilon=epsilon, train=True, pix_mux=pix_mux,
        pix_lo=lo, n_pix_local=n_local, mesh=mesh)
    img, aux = _deep_aux(img_sum, stats, cfg, mesh)
    aux["loss"] = stats["loss_sum"]
    eps_next = nq.decay_epsilon(epsilon, cfg.samples_per_pixel, dl)
    return img, net, opt_state, eps_next, aux


def _spp_local(cfg: RenderConfig, mesh: Mesh) -> RenderConfig:
    if cfg.samples_per_pixel % mesh.size:
        raise ValueError(f"spp {cfg.samples_per_pixel} must divide the "
                         f"mesh size {mesh.size}")
    return dataclasses.replace(
        cfg, samples_per_pixel=cfg.samples_per_pixel // mesh.size)


def render_guided_mega_dp(seed, scene: Scene, camera: Camera,
                          table: TriBinCDF, cfg: RenderConfig,
                          mesh: Mesh | None = None, pix_mux: int = PIX_MUX,
                          r_tile: int = R_TILE):
    """Seed-parallel guided-megakernel inference (B3): every rank renders
    the full frame at spp / world with its own seed and the images are
    averaged (one psum): the single-process estimator at the same total
    spp.  ``seed``: an int, or one int seed a rank.  spp must divide by
    the world size (ValueError).  Returns (image, aux with
    avg_path_length)."""
    mesh = mesh or make_mesh()
    cfg_local = _spp_local(cfg, mesh)
    img, aux = render_guided_mega(seed_of_rank(seed, mesh), scene, camera,
                                  table, cfg_local, mesh.device,
                                  r_tile=r_tile, pix_mux=pix_mux)
    img = psum(img.contiguous(), mesh) / mesh.size
    plen = _sum_over_ranks(aux["avg_path_length"], mesh) / mesh.size
    return img, {"avg_path_length": plen}


def sarsa_mega_train_dp(seed, scene: Scene, camera: Camera,
                        table: TriBinCDF, q: torch.Tensor,
                        visits: torch.Tensor, cfg: RenderConfig,
                        radiance_threshold: float, mesh: Mesh | None = None,
                        pix_mux: int = PIX_MUX, r_tile: int = R_TILE):
    """Sharded in-kernel binned-SARSA learning frame (B2): each rank runs
    the full learning frame at spp / world from the same (q0, v0), then
    the ranks' updates merge by the composition algebra of the running
    mean, as the JAX function does it (at any world size):

        c_i = v_i - v0;   s_i = q_i (1 + v0 + c_i) - q0 (1 + v0)
        q = (q0 (1 + v0) + sum s_i) / (1 + v0 + sum c_i), at least the
        threshold, and q0 where sum c_i == 0;   visits = v0 + sum c_i.

    The merge is a valid serialisation of the same per-ray contributions
    (each rank bootstraps from its own evolving Q within the frame), not
    a replay of one process's order; the visit counts stay exact.
    ``seed``: an int, or one int seed a rank.  Returns (image, q, visits,
    aux with td_scatter_count), replicated on every rank."""
    mesh = mesh or make_mesh()
    cfg_local = _spp_local(cfg, mesh)
    dev = mesh.device
    q0 = q.to(device=dev, dtype=torch.float32)
    v0 = visits.to(device=dev, dtype=torch.float32)
    img, q_i, v_i, aux = render_sarsa_mega_train(
        seed_of_rank(seed, mesh), scene, camera, table, q0, v0, cfg_local,
        radiance_threshold, dev, r_tile=r_tile, pix_mux=pix_mux)
    c_i = v_i - v0
    s_i = q_i * (1.0 + v0 + c_i) - q0 * (1.0 + v0)
    # one collective for both sums
    s_all, c_all = psum(torch.stack([s_i, c_i]), mesh)
    q_new = (q0 * (1.0 + v0) + s_all) / (1.0 + v0 + c_all)
    q_new = torch.clamp(q_new, min=radiance_threshold)
    q_new = torch.where(c_all > 0, q_new, q0)
    img = psum(img.contiguous(), mesh) / mesh.size
    td = _sum_over_ranks(aux["td_scatter_count"], mesh)
    return img, q_new, v0 + c_all, {"td_scatter_count": td}
