"""Neural-Q path tracer with online TD training, lockstep (counterpart of
``rlrpt_tpu/deep/neural_q.py``; ref: neural_q_pathtracer.cu,
nn_rendering_helpers.cu).

All H*W rays advance one bounce at a time; every bounce forwards the MLP
to choose directions, traces, forwards it again for the TD targets and
trains it with one Adam step per 4096-ray minibatch, in order:

* ray states 0 active, 1 terminated this bounce, 2 learning-only;
  terminated rays respawn at random surface points as learning-only
  (neural_q_pathtracer.cu:519-525, nn_rendering_helpers.cu:241-277);
* rewards and discounts per hit (neural_q_pathtracer.cu:646-752): miss
  r = 0, gamma = 0; light r = luminance * 200, gamma = 0; surface r = 0,
  gamma = surface luminance; throughput moves only for state 0;
* directions (nn_rendering_helpers.cu:300-489): with probability epsilon
  a uniform random sector (pdf RHO), else importance sampling over
  Q * cos(theta), pdf = RHO * p / GRID_RHO; an all-zero Q row (the output
  ReLU allows it) falls back to uniform;
* TD target r + gamma * max(Q_0, max_{a>=1} Q_a cos_a): the reference
  seeds its max scan with Q(s', 0) unweighted by cos (reproduced);
* loss sum((td - Q(s, a))^2) per minibatch, Adam (``nn.adam``); epsilon
  decays per spp sample, floored at epsilon_min.

The hit is kernel B4a (``closest_hit_pallas_mat``) on the card and its
plain twin on the CPU.  The network's parameters and the Adam state are
updated in place (the JAX functions return new ones); the functions
return them too, so call sites read alike.  The bounce loop reads its
continue flag on the host once per bounce (the JAX package decides in a
while_loop); inside the minibatch loop only a minibatch width's first
step on a card waits for the host, when ``train_on_batches`` captures it
as a CUDA graph.
Randomness comes from a ``torch.Generator``, so frames match the JAX
package's in distribution, not per pixel.
"""

from __future__ import annotations

import math
import weakref
from typing import NamedTuple

import numpy as np
import torch

from rlrpt_tpu_torch.camera import Camera, primary_rays
from rlrpt_tpu_torch.config import (RHO, DeepLearningConfig,
                                    RadianceVolumeConfig, RenderConfig)
from rlrpt_tpu_torch.nn.adam import AdamState, adam_init, adam_update
from rlrpt_tpu_torch.nn.dq_network import DQNetwork
from rlrpt_tpu_torch.ops import hemisphere as hs
from rlrpt_tpu_torch.ops.bvh import build_bvh
from rlrpt_tpu_torch.ops.intersect import closest_hit
from rlrpt_tpu_torch.ops.intersect_pallas import (closest_hit_pallas_mat,
                                                  material_rows,
                                                  pack_scene_mxu)
from rlrpt_tpu_torch.ops.linalg import make_frame
from rlrpt_tpu_torch.parallel.mesh import any_rank, psum
from rlrpt_tpu_torch.scene.scene import AREA_LIGHT, NOTHING, SURFACE, Scene
from rlrpt_tpu_torch.utils import profiling

ACTIVE, TERMINATED, LEARNING_ONLY = 0, 1, 2


class NeuralQState(NamedTuple):
    """SoA ray state (ref: neural_q_pathtracer.cu:76-96)."""

    loc: torch.Tensor         # (R, 3) current state position
    prev_loc: torch.Tensor    # (R, 3) where the last action was taken
    normal: torch.Tensor      # (R, 3)
    direction: torch.Tensor   # (R, 3)
    states: torch.Tensor      # (R,) int32: 0 active, 1 terminated, 2 learning
    rewards: torch.Tensor     # (R,)
    discounts: torch.Tensor   # (R,)
    throughput: torch.Tensor  # (R, 3)
    bounces: torch.Tensor     # (R,) int32
    action: torch.Tensor      # (R,) int64 sector chosen at prev_loc


def init_rays(generator: torch.Generator, camera: Camera,
              cfg: RenderConfig) -> NeuralQState:
    """initialise_ray (ref: neural_q_pathtracer.cu:603-643)."""
    o, d = primary_rays(generator, camera, cfg.width, cfg.height, cfg.focal)
    return init_rays_from(o, d, cfg)


def init_rays_from(o: torch.Tensor, d: torch.Tensor,
                   cfg: RenderConfig) -> NeuralQState:
    n, dev = o.shape[0], o.device
    return NeuralQState(
        loc=o, prev_loc=o, normal=torch.zeros_like(o), direction=d,
        states=torch.zeros((n,), dtype=torch.int32, device=dev),
        rewards=torch.zeros((n,), dtype=torch.float32, device=dev),
        discounts=torch.ones((n,), dtype=torch.float32, device=dev),
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        bounces=torch.full((n,), cfg.max_ray_bounces, dtype=torch.int32,
                           device=dev),
        action=torch.zeros((n,), dtype=torch.int64, device=dev))


def _q_forward(net: DQNetwork, scene: Scene, loc: torch.Tensor,
               dl: DeepLearningConfig) -> torch.Tensor:
    if dl.train_on_position:
        return net(loc)
    return net.forward_relative(scene.vertices_flat, loc)


def f32(x: float) -> float:
    """x rounded to float32 (the JAX package keeps epsilon as f32)."""
    return float(np.float32(x))


def decay_epsilon(epsilon: float, steps: int,
                  dl: DeepLearningConfig) -> float:
    """max(epsilon - decay * steps, epsilon_min) in float32, as JAX
    computes it (the f32 product, then the f32 difference)."""
    return f32(max(np.float32(epsilon)
                   - np.float32(dl.epsilon_decay * steps),
                   np.float32(dl.epsilon_min)))


# ---- direction sampling --------------------------------------------------

def sample_q_directions_u(uniforms: torch.Tensor, qs: torch.Tensor,
                          normal: torch.Tensor, epsilon,
                          grid_resolution: int, grid_rho: float,
                          cos: torch.Tensor | None = None):
    """Epsilon-greedy / importance sector sampling for the given uniforms
    (ref: nn_rendering_helpers.cu:331-489).

    ``uniforms`` (N, 5): the explore draw (<= epsilon explores), the
    inverse-CDF draw, the random-sector draw and the in-sector jitter
    (2), in the JAX code's k_eps, k_r, k_rand, k_jit roles.  ``epsilon``:
    a float or an (N,) tensor.  ``cos``: the sector cosines
    (hemisphere.sector_cos_thetas), computed here if not given.  Returns
    (direction, sector (N,) int64, pdf (N,))."""
    s = grid_resolution * grid_resolution
    if cos is None:
        cos = hs.sector_cos_thetas(grid_resolution, qs.device)
    w = qs * cos[None, :]
    total = w.sum(dim=-1, keepdim=True)
    q_dist = torch.where(total > 0.0,
                         w / torch.where(total == 0.0, 1.0, total), 1.0 / s)
    cdf = torch.cumsum(q_dist, dim=-1)
    sector_imp = torch.clamp((cdf <= uniforms[:, 1:2]).sum(dim=-1),
                             max=s - 1)
    p_imp = q_dist.gather(1, sector_imp[:, None])[:, 0]
    pdf_imp = RHO * (p_imp / grid_rho)
    # the random sector: the reference's (u - 1e-4) * S, truncated
    sector_rand = torch.clamp(((uniforms[:, 2] - 1e-4) * s).to(torch.int32),
                              0, s - 1).long()
    explore = uniforms[:, 0] <= epsilon
    sector = torch.where(explore, sector_rand, sector_imp)
    pdf = torch.where(explore, RHO, pdf_imp)
    direction = hs.sector_direction(uniforms[:, 3:5], sector,
                                    make_frame(normal), grid_resolution)
    return direction, sector, pdf


def sample_directions(generator: torch.Generator, qs: torch.Tensor,
                      state: NeuralQState, epsilon, grid_resolution: int,
                      grid_rho: float):
    """Directions for every ray of ``state`` from its Q row; returns
    (direction, sector, factor = cos / pdf), the factor applied by the
    caller to active rays."""
    u = torch.rand((qs.shape[0], 5), generator=generator, device=qs.device)
    d, sector, pdf = sample_q_directions_u(u, qs, state.normal, epsilon,
                                           grid_resolution, grid_rho)
    cos_theta = torch.sum(state.normal * d, dim=-1)
    return d, sector, cos_theta / torch.clamp(pdf, min=1e-12)


# ---- tracing, targets, training ------------------------------------------

def make_hit_fn(scene: Scene, use_pallas: bool = True,
                ray_tile: int = 8192):
    """The frame's closest hit: kernel B4a over tables and a BVH made
    once, or with ``use_pallas`` False the plain ``ops.intersect``
    closest hit (tiled by ``ray_tile``) with gathered material rows, the
    JAX package's non-Pallas option.  Returns hit_fn(o, d) -> (Hit,
    material rows (R, 16))."""
    if not use_pallas:
        def plain(o, d):
            hit = closest_hit(o, d, scene, ray_tile=ray_tile)
            return hit, material_rows(scene, hit.tri)
        return plain
    tris, mat = pack_scene_mxu(scene)
    bvh = build_bvh(tris)
    return lambda o, d: closest_hit_pallas_mat(o, d, scene, tris, mat,
                                               bvh=bvh)


def trace_step(state: NeuralQState, scene: Scene, bounce: int,
               cfg: RenderConfig, dl: DeepLearningConfig, hit_fn=None):
    """trace_ray for every ray (ref: neural_q_pathtracer.cu:646-752).
    ``hit_fn`` defaults to kernel B4a (``make_hit_fn``).  Returns
    (new_state, any active ray hit a surface: a () bool tensor)."""
    if hit_fn is None:
        hit_fn = make_hit_fn(scene)
    hit, mat = hit_fn((state.loc + cfg.eps * state.direction).contiguous(),
                      state.direction.contiguous())
    is_nothing = hit.hit_type == NOTHING
    is_light = hit.hit_type == AREA_LIGHT
    is_surface = hit.hit_type == SURFACE
    active = state.states == ACTIVE

    lum = mat[:, 10]
    rewards = torch.where(is_light, lum * dl.light_reward_scale, 0.0)
    discounts = torch.where(is_surface, lum, 0.0)
    tp_mult = torch.where(
        is_nothing[:, None], cfg.environment_light,
        torch.where(is_light[:, None], mat[:, 6:9], mat[:, 3:6] / math.pi))
    throughput = torch.where(active[:, None], state.throughput * tp_mult,
                             state.throughput)
    terminated = is_nothing | is_light
    bounces = torch.where(active & terminated, bounce, state.bounces)
    states = torch.where(terminated, TERMINATED, state.states)
    # the training input is the pre-trace location of every ray (the
    # reference snapshots the whole encoding buffer, :407-409)
    new_state = state._replace(
        loc=torch.where(is_surface[:, None], hit.position, state.loc),
        prev_loc=state.loc,
        normal=torch.where(is_surface[:, None], hit.normal, state.normal),
        rewards=rewards, discounts=discounts, throughput=throughput,
        bounces=bounces, states=states)
    return new_state, (active & is_surface).any()


def bootstrap_max(qs: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """max_a Q(s', a) cos_a with the reference's scan seed: Q_0 enters
    unweighted (ref: nn_rendering_helpers.cu:91-140)."""
    weighted = (qs[:, 1:] * cos[None, 1:]).max(dim=-1).values
    return torch.maximum(qs[:, 0], weighted)


@torch.no_grad()
def compute_td_targets(net: DQNetwork, scene: Scene, state: NeuralQState,
                       grid_resolution: int,
                       dl: DeepLearningConfig) -> torch.Tensor:
    """r + gamma * bootstrap_max(Q(s')) for rays not terminated, r for
    terminated ones (ref: nn_rendering_helpers.cu:91-140)."""
    qs_next = _q_forward(net, scene, state.loc, dl)
    max_q = bootstrap_max(qs_next,
                          hs.sector_cos_thetas(grid_resolution,
                                               qs_next.device))
    return torch.where(state.states != TERMINATED,
                       state.rewards + state.discounts * max_q, state.rewards)


def td_loss(net: DQNetwork, scene: Scene, loc: torch.Tensor,
            action: torch.Tensor, td: torch.Tensor, weight: torch.Tensor,
            dl: DeepLearningConfig) -> torch.Tensor:
    """sum(weight * (td - Q(loc, action))^2), one minibatch's loss."""
    q = _q_forward(net, scene, loc, dl)
    qa = q.gather(1, action[:, None])[:, 0]
    return torch.sum(weight * (td - qa) ** 2)


def _grad_step(net: DQNetwork, scene: Scene, params: list,
               loc: torch.Tensor, action: torch.Tensor, td: torch.Tensor,
               w: torch.Tensor, dl: DeepLearningConfig, mesh=None):
    """One minibatch's loss, gradients and live-ray count; with a
    ``mesh``, each summed over the ranks in one psum."""
    loss = td_loss(net, scene, loc, action, td, w, dl)
    grads = torch.autograd.grad(loss, params)
    n_live = w.sum()
    if mesh is not None:
        flat = psum(torch.cat([g.reshape(-1) for g in grads]
                              + [loss.detach().reshape(1),
                                 n_live.reshape(1)]), mesh)
        grads = [g.view_as(p) for g, p in
                 zip(flat[:-2].split([p.numel() for p in params]), params)]
        loss, n_live = flat[-2], flat[-1]
    return loss, grads, n_live


def _adam_step(params: list, grads, opt_state: AdamState, n_live,
               dl: DeepLearningConfig) -> None:
    adam_update(params, grads, opt_state, dl.learning_rate, dl.adam_b1,
                dl.adam_b2, dl.adam_eps, live=n_live > 0)


def _eager_step(net, opt_state, scene, params, batch, dl,
                mesh=None) -> torch.Tensor:
    """One minibatch's step issued op by op; returns its loss."""
    with profiling.span("train_on_batches.grad"):
        loss, grads, n_live = _grad_step(net, scene, params, *batch, dl,
                                         mesh)
    with profiling.span("train_on_batches.adam"):
        _adam_step(params, grads, opt_state, n_live, dl)
    return loss


def _graphed(device: torch.device, mesh) -> bool:
    """Whether ``train_on_batches`` replays its minibatch steps as CUDA
    graphs: on a card, without a mesh (a mesh's psum stays eager)."""
    return device.type == "cuda" and mesh is None


class _StepGraph:
    """One minibatch step (``_grad_step``, then ``_adam_step``) of one
    width, captured as a CUDA graph in a memory pool of its own.  Its
    static inputs (loc (b, 3), action (b,), td (b,), weight (b,)) are
    filled by a copy before each replay; the loss is a static output.
    The graph reads and writes the parameters, Adam's state and the
    scene's vertices at the addresses it was captured with."""

    def __init__(self, net, opt_state, scene, params, batch, dl, stream):
        self.inputs = tuple(torch.empty_like(x) for x in batch)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            loss, grads, n_live = _grad_step(net, scene, params,
                                             *self.inputs, dl)
            _adam_step(params, grads, opt_state, n_live, dl)
        self.loss = loss.detach()

    def __call__(self, batch) -> torch.Tensor:
        for static, x in zip(self.inputs, batch):
            static.copy_(x)
        self.graph.replay()
        return self.loss


#: The captured steps of each Adam state, by the id of its step count,
#: then by ``_graph_key`` and width; an entry dies with its state, so a
#: copy of a network captures its own and never replays another's.
_GRAPHS: dict[int, dict] = {}
#: The stream each card captures on (and runs a width's first step on).
_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def _graphs_of(opt_state: AdamState) -> dict:
    key = id(opt_state.count)
    graphs = _GRAPHS.get(key)
    if graphs is None:
        graphs = _GRAPHS[key] = {}
        weakref.finalize(opt_state.count, _GRAPHS.pop, key, None)
    return graphs


def _graph_key(params, opt_state: AdamState, scene: Scene,
               dl: DeepLearningConfig) -> tuple:
    """What a captured step holds: the addresses of the parameters, the
    moments, the step count and (for the relative encoding) the scene's
    vertices, and the rates it was captured with."""
    held = [*params, *opt_state.mu, *opt_state.nu, opt_state.count]
    if not dl.train_on_position:
        held += [scene.v0, scene.v1, scene.v2]
    return (tuple(t.data_ptr() for t in held), dl.train_on_position,
            dl.learning_rate, dl.adam_b1, dl.adam_b2, dl.adam_eps)


def train_on_batches(net: DQNetwork, opt_state: AdamState, scene: Scene,
                     prev_loc: torch.Tensor, actions: torch.Tensor,
                     tds: torch.Tensor, dl: DeepLearningConfig,
                     weights: torch.Tensor | None = None,
                     mesh=None, on_step=None) -> torch.Tensor:
    """One Adam step per minibatch of dl.batch_size rays, in order (ref:
    neural_q_pathtracer.cu:421-513).  ``weights`` (R,) weight the
    squared errors (the wavefront's pending mask).  A minibatch whose
    weights are all zero (padding, or nothing pending) leaves the network
    and the state as they were, decided on the device.  Updates ``net``
    and ``opt_state`` in place; returns the summed loss (a () tensor).

    On a card without a mesh each step is a CUDA graph, one per Adam
    state and minibatch width (``_StepGraph``): a width's first step runs
    op by op on the capture stream, then is captured, and its later steps
    replay the graph, the same kernels in the same order, so the weights
    are the ones the op-by-op loop gives, bit for bit.  Elsewhere every
    step runs op by op.

    With a ``mesh`` (parallel.mesh) each rank holds its share of every
    global minibatch: one psum per minibatch sums the gradients, the loss
    and the live-ray count, in one flat buffer, so every rank takes the
    same Adam step (or none, when no rank has a live ray) and the
    replicas stay bit-identical.  Every rank must hold as many rays
    (``prev_loc.shape[0]``) and the same ``dl.batch_size``, so all run
    the same number of minibatches.

    ``on_step``, if given, is called with no argument after each
    minibatch's step (taken or skipped): the capture hook of
    ``deep_wavefront`` copies the state there.

    While a profiler records, the spans ``train_on_batches.grad`` (a
    minibatch's loss and gradients) and ``.adam`` (its step) time each
    step run op by op, ``.replay`` each replayed one (its input copies
    and the replay) and ``.capture`` each capture, whose host wait is
    ``sync.graph_capture``; ``profiling.RECORDER`` counts the
    minibatches, the replays (``train.graph_replays``), the captures
    (``train.graph_captures``) and the rows with a nonzero weight
    (``train.rows``, on the device)."""
    r = prev_loc.shape[0]
    b = min(dl.batch_size, r)
    if weights is None:
        weights = torch.ones((r,), dtype=torch.float32, device=tds.device)
    tds = tds.detach()
    params = list(net.parameters())
    loss_sum = torch.zeros((), dtype=torch.float32, device=tds.device)
    counting = profiling.recording()
    if counting:
        rec = profiling.RECORDER
        rec.counts["train.minibatches"] += -(-r // b) if b else 0
        rec.tally("train.rows", (weights != 0).sum())
    graphs = (_graphs_of(opt_state) if _graphed(tds.device, mesh)
              else None)
    if graphs is not None:
        base = _graph_key(params, opt_state, scene, dl)
        stream = _STREAMS.get(tds.device)
        if stream is None:
            stream = _STREAMS[tds.device] = torch.cuda.Stream(tds.device)
    replays = captures = 0
    for s in range(0, r, b):
        batch = (prev_loc[s:s + b], actions[s:s + b], tds[s:s + b],
                 weights[s:s + b])
        if graphs is None:
            loss = _eager_step(net, opt_state, scene, params, batch, dl,
                               mesh)
        elif (key := (base, batch[0].shape[0])) in graphs:
            with profiling.span("train_on_batches.replay"):
                loss = graphs[key](batch)
            replays += 1
        else:
            # the real step, on the stream the capture will use, so its
            # cuBLAS handles and autograd are warm there; then the capture,
            # which runs nothing
            main = torch.cuda.current_stream(tds.device)
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                loss = _eager_step(net, opt_state, scene, params, batch, dl)
            main.wait_stream(stream)
            with profiling.span("train_on_batches.capture"), \
                    profiling.host_sync("graph_capture", tds):
                graphs[key] = _StepGraph(net, opt_state, scene, params,
                                         batch, dl, stream)
            captures += 1
        if on_step is not None:
            on_step()
        loss_sum = loss_sum + loss.detach()
    if counting:
        rec.counts["train.graph_replays"] += replays
        rec.counts["train.graph_captures"] += captures
    return loss_sum


def respawn_terminated(generator: torch.Generator, state: NeuralQState,
                       scene: Scene) -> NeuralQState:
    """Terminated rays restart at uniform random surface points as
    learning-only rays (ref: nn_rendering_helpers.cu:241-277; the u+v > 1
    fold replaces the reference's rejection loop, same distribution; the
    reference writes pos.y into z and pos.z into y, :267-269, an index bug
    not reproduced)."""
    n, dev = state.loc.shape[0], state.loc.device
    tri = torch.randint(0, scene.n_surfaces, (n,), generator=generator,
                        device=dev)
    uv = torch.rand((n, 2), generator=generator, device=dev)
    uv = torch.where((uv.sum(-1) > 1.0)[:, None], 1.0 - uv, uv)
    v0 = scene.v0[tri]
    pos = (v0 + uv[:, 0:1] * (scene.v1[tri] - v0)
           + uv[:, 1:2] * (scene.v2[tri] - v0))
    dead = state.states == TERMINATED
    return state._replace(
        loc=torch.where(dead[:, None], pos, state.loc),
        normal=torch.where(dead[:, None], scene.normal[tri], state.normal),
        states=torch.where(dead, LEARNING_ONLY, state.states))


def _trace_sample(generator, scene, camera, net, opt_state, epsilon,
                  cfg: RenderConfig, rl: RadianceVolumeConfig,
                  dl: DeepLearningConfig, hit_fn, rays=None, mesh=None):
    """One spp sample, bounce by bounce, training online.  Returns (final
    ray state, summed loss).  ``rays``: (origins, directions) to trace in
    place of the camera's (parallel.dp feeds each rank its shard).  With a
    ``mesh`` (parallel.mesh) the gradients are summed over the ranks per
    minibatch (train_on_batches) and the bounce loop ends when no rank's
    active ray hit a surface."""
    if rays is None:
        state = init_rays(generator, camera, cfg)
    else:
        state = init_rays_from(rays[0], rays[1], cfg)
    loss = torch.zeros((), dtype=torch.float32, device=state.loc.device)
    for bounce in range(cfg.max_ray_bounces):
        if bounce > 0:     # primary rays keep the camera's directions
            with torch.no_grad():
                qs = _q_forward(net, scene, state.loc, dl)
            d, a, factor = sample_directions(generator, qs, state, epsilon,
                                             rl.grid_resolution, rl.grid_rho)
            tp = torch.where((state.states == ACTIVE)[:, None],
                             state.throughput * factor[:, None],
                             state.throughput)
            state = state._replace(direction=d, action=a, throughput=tp)
        state, go = trace_step(state, scene, bounce, cfg, dl, hit_fn)
        if bounce > 0:
            td = compute_td_targets(net, scene, state, rl.grid_resolution,
                                    dl)
            loss = loss + train_on_batches(net, opt_state, scene,
                                           state.prev_loc, state.action, td,
                                           dl, mesh=mesh)
        state = respawn_terminated(generator, state, scene)
        if not any_rank(go, mesh):
            break
    return state, loss


def _generator(generator_or_seed, device) -> torch.Generator:
    if isinstance(generator_or_seed, torch.Generator):
        return generator_or_seed
    return torch.Generator(device=device).manual_seed(int(generator_or_seed))


def render_frame_neural_q(generator_or_seed, scene: Scene, camera: Camera,
                          net: DQNetwork, opt_state: AdamState, epsilon,
                          cfg: RenderConfig, rl: RadianceVolumeConfig,
                          dl: DeepLearningConfig):
    """Render one frame with online training.  Returns (image (H, W, 3),
    net, opt_state, epsilon after spp decays, aux) with per-spp tensors
    avg_path_length, loss and zero_contribution_light_paths, the lines of
    the reference's nn_training_stats.txt (neural_q_pathtracer.cu:
    577-583)."""
    device = next(net.parameters()).device
    gen = _generator(generator_or_seed, device)
    scene = scene.to(device)
    hit_fn = make_hit_fn(scene)
    n, spp = cfg.n_pixels, cfg.samples_per_pixel
    total_tp = torch.zeros((n, 3), dtype=torch.float32, device=device)
    stats = ([], [], [])
    for _ in range(spp):
        state, loss = _trace_sample(gen, scene, camera, net, opt_state,
                                    epsilon, cfg, rl, dl, hit_fn)
        total_tp = total_tp + state.throughput
        stats[0].append(state.bounces.float().mean())
        stats[1].append(loss)
        stats[2].append((state.throughput < cfg.throughput_threshold)
                        .all(dim=-1).sum())
        epsilon = decay_epsilon(epsilon, 1, dl)
    img = (total_tp / spp).reshape(cfg.height, cfg.width, 3)
    aux = {"avg_path_length": torch.stack(stats[0]),
           "loss": torch.stack(stats[1]),
           "zero_contribution_light_paths": torch.stack(stats[2])}
    return img, net, opt_state, epsilon, aux


def init_neural_q(generator_or_seed, scene: Scene, dl: DeepLearningConfig,
                  grid_resolution: int = 12, device="cuda"):
    """A Glorot-initialised network for the scene and its Adam state, on
    ``device`` (the card unless the caller asks for the CPU).  The
    input is 3 floats for TRAIN_ON_POSITION, else the scene's 9T vertex
    floats (ref: neural_q_pathtracer.cu:49, dq_network.cu:8-17); the
    weights are drawn on the CPU from the seed, then moved."""
    gen = _generator(generator_or_seed, "cpu")
    input_dim = 3 if dl.train_on_position else scene.vertices_count
    net = DQNetwork(input_dim, grid_resolution * grid_resolution,
                    dl.hidden_sizes, generator=gen).to(device)
    return net, adam_init(net.parameters())
