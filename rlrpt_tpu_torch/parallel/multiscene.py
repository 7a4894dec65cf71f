"""Multi-scene batch rendering and joint deep-Q training over the ranks
(counterpart of ``rlrpt_tpu/parallel/multiscene.py``).

* render_multiscene_dp, the batch render: the scene list is dealt out to
  the ranks, each rank renders its scenes with the default tracer, and the
  images are gathered; no collective before that.
* train_multiscene_deep_dp, the joint training: each rank runs the
  regenerative deep wavefront (deep.deep_wavefront, B4a on the card) on
  its own scene while all ranks share one replicated net; per-minibatch
  gradients are psum'd (deep.neural_q.train_on_batches), so the net
  trains on every scene at once.

Scenes are padded to a common (surfaces, lights) shape with degenerate
zero-area triangles at the origin, inserted between the surfaces and the
lights: such a triangle is never hit (its determinant is 0), so the
render does not change, the relative encoding gets constant zeros, and
one (9 * T_pad)-input net serves every scene (nn.dq_network's
forward_relative).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import (DeepLearningConfig, RadianceVolumeConfig,
                                    RenderConfig)
from rlrpt_tpu_torch.deep.deep_wavefront import trace_frame_deep_wavefront
from rlrpt_tpu_torch.deep.neural_q import decay_epsilon
from rlrpt_tpu_torch.integrators.default_tracer import render_default
from rlrpt_tpu_torch.nn.adam import AdamState, adam_init
from rlrpt_tpu_torch.nn.dq_network import DQNetwork
from rlrpt_tpu_torch.parallel.dp import _max_over_ranks
from rlrpt_tpu_torch.parallel.mesh import (Mesh, all_gather, make_mesh,
                                           rank_seed)
from rlrpt_tpu_torch.scene.scene import Scene

_FIELDS = ("v0", "v1", "v2", "normal", "diffuse_c", "emission", "luminance")


def pad_scene(scene: Scene, ns: int, nl: int) -> Scene:
    """Pad to ``ns`` surfaces and ``nl`` lights with degenerate zero
    triangles: the surface padding after the surfaces, the light padding
    after the lights."""
    n_lights = scene.n_triangles - scene.n_surfaces
    s_pad, l_pad = ns - scene.n_surfaces, nl - n_lights
    if s_pad < 0 or l_pad < 0:
        raise ValueError(f"cannot pad {scene.n_surfaces} surfaces and "
                         f"{n_lights} lights to {ns} and {nl}")
    at = scene.n_surfaces

    def pad(a):
        z = lambda k: a.new_zeros((k,) + a.shape[1:])  # noqa: E731
        return torch.cat([a[:at], z(s_pad), a[at:], z(l_pad)])

    return Scene(**{f: pad(getattr(scene, f)) for f in _FIELDS},
                 n_surfaces=ns)


def stack_scenes(scenes: Sequence[Scene]) -> Scene:
    """Pad the scenes to a common shape and stack them: a Scene whose
    arrays carry a leading scene axis."""
    ns = max(s.n_surfaces for s in scenes)
    nl = max(s.n_triangles - s.n_surfaces for s in scenes)
    padded = [pad_scene(s, ns, nl) for s in scenes]
    return Scene(**{f: torch.stack([getattr(s, f) for s in padded])
                    for f in _FIELDS}, n_surfaces=ns)


def scene_at(batched: Scene, i: int) -> Scene:
    """Scene ``i`` of a stacked batch."""
    return dataclasses.replace(
        batched, **{f: getattr(batched, f)[i] for f in _FIELDS})


def _dealt(n: int, mesh: Mesh):
    """The scene list repeated up to a multiple of the world size, and
    this rank's slice of it."""
    reps = -(-n // mesh.size) * mesh.size
    per = reps // mesh.size
    return [i % n for i in range(reps)], range(mesh.rank * per,
                                               (mesh.rank + 1) * per)


def render_multiscene_dp(seed: int, scenes: Sequence[Scene],
                         cameras: Sequence[Camera], cfg: RenderConfig,
                         mesh: Mesh | None = None) -> torch.Tensor:
    """Render each scene with its camera, the scenes dealt out to the
    ranks (each rank renders its padded scenes with its own seed).
    Returns the images (n_scenes, H, W, 3) on every rank."""
    mesh = mesh or make_mesh()
    idx, mine = _dealt(len(scenes), mesh)
    batched = stack_scenes([scenes[i] for i in idx]).to(mesh.device)
    imgs = torch.stack([
        render_default(rank_seed(seed, mesh.rank), scene_at(batched, j),
                       cameras[idx[j]], cfg, mesh.device)[0] for j in mine])
    return all_gather(imgs, mesh)[:len(scenes)]


def init_multiscene_neural_q(seed: int, scenes: Sequence[Scene],
                             dl: DeepLearningConfig,
                             grid_resolution: int = 12, device="cuda"):
    """One shared net sized for the padded scene batch, on ``device``:
    the relative encoding's input is 9 * T_pad floats (ref:
    neural_q_pathtracer.cu:49, dq_network.cu:8-17).  Returns (net,
    opt_state, batched), the stacked scenes it was sized for; the weights
    are drawn on the CPU from the seed, as deep.neural_q.init_neural_q's."""
    batched = stack_scenes(scenes)
    t_pad = batched.v0.shape[1]
    input_dim = 3 if dl.train_on_position else t_pad * 9
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    net = DQNetwork(input_dim, grid_resolution * grid_resolution,
                    dl.hidden_sizes, generator=gen).to(device)
    return net, adam_init(net.parameters()), batched


def train_multiscene_deep_dp(seed: int, scenes: Sequence[Scene],
                             cameras: Sequence[Camera], net: DQNetwork,
                             opt_state: AdamState, epsilon,
                             cfg: RenderConfig, rl: RadianceVolumeConfig,
                             dl: DeepLearningConfig, mesh: Mesh | None = None,
                             pix_mux: int = 2, batched: Scene | None = None):
    """One joint deep-Q training frame over a batch of scenes: each rank
    owns one scene (its slice of the list repeated up to a multiple of the
    world size) and runs the full regenerative training frame on it, the
    gradients psum'd per minibatch, so the replicated net takes one joint
    update per minibatch, and the phase exits are taken on the ranks'
    reduced live counts.  With more scenes than ranks (where the JAX
    function has no answer) each rank trains on its slice's scenes one
    after another, every frame from ``epsilon``; all ranks hold as many
    scenes, so they run the same frames.

    ``net`` must come from init_multiscene_neural_q over the same scene
    list; pass its ``batched`` to skip re-stacking.  Returns (images
    (n_scenes, H, W, 3), net, opt_state, epsilon advanced by spp decays,
    aux with the joint loss and per-scene avg_path_length and
    zero_contribution_light_paths); the net and the state are updated in
    place."""
    mesh = mesh or make_mesh()
    n = len(scenes)
    idx, mine = _dealt(n, mesh)
    if batched is None or batched.v0.dim() != 3 \
            or batched.v0.shape[0] != len(idx):
        batched = stack_scenes([scenes[i] for i in idx])
    imgs, paths, zclps, iters = [], [], [], 0
    loss = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for j in mine:
        img_sum, stats = trace_frame_deep_wavefront(
            rank_seed(seed, mesh.rank), scene_at(batched, j).to(mesh.device),
            cameras[idx[j]], net, cfg, rl, dl, opt_state=opt_state,
            epsilon=epsilon, train=True, pix_mux=pix_mux, mesh=mesh)
        imgs.append(img_sum)
        paths.append(stats["path_sum"])
        zclps.append(stats["zclp"])
        loss = loss + stats["loss_sum"]
        iters = iters + stats["phase_iterations"].sum()
    spp, total = cfg.samples_per_pixel, cfg.n_pixels * cfg.samples_per_pixel
    imgs = (all_gather(torch.stack(imgs), mesh)[:n] / spp).reshape(
        n, cfg.height, cfg.width, 3)
    aux = {"loss": loss,
           "avg_path_length": all_gather(torch.stack(paths), mesh)[:n]
           / total,
           "zero_contribution_light_paths": all_gather(torch.stack(zclps),
                                                       mesh)[:n],
           "wavefront_iterations": _max_over_ranks(iters, mesh)}
    return (imgs, net, opt_state,
            decay_epsilon(epsilon, cfg.samples_per_pixel, dl), aux)
