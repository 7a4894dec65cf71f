"""Regenerative-wavefront neural-Q tracers, the fast deep paths
(counterpart of ``rlrpt_tpu/deep/deep_wavefront.py``).

The estimator and learning rule of deep.pretrained / deep.neural_q on the
slot wavefront of integrators.sarsa_wavefront:

* a slot owns pix_mux pixels and starts the next sample, then the next
  pixel, the moment a sample ends, so the closest hit (kernel B4a) and
  the MLP forward are spent on live rays;
* cascaded drain: once the live count fits a DRAIN_FACTOR-times narrower
  wavefront, the live slots are compacted to a prefix, the dead tail's
  banked radiance is flushed, and a narrower loop goes on;
* between phase boundaries the hit traces up to the last live slot, a
  high-water mark ``m`` that stays a device int32 tensor;
* ONE forward per iteration serves both the sampling distribution at the
  new vertex and the TD bootstrap of the transition into it (the
  lockstep forwards twice per bounce);
* training: the pending transitions (prev_loc, action, td) train the net
  through deep.neural_q.train_on_batches, weighted by the pending mask;
  a minibatch with nothing pending does not advance Adam.

Deliberate deviations from the lockstep (the JAX module's, kept):
regeneration replaces the learning-only respawn; epsilon decays per
sample ordinal of each pixel (a per-lane epsilon), and the frame returns
epsilon advanced by spp decays; a transition's update lands one iteration
later relative to the sampling at its new vertex; the bounce cap
contributes tp * brdf (no direction factor), the lockstep's throughput at
loop exit.

The loop reads the live count on the host once every SYNC_EVERY
iterations; the count never rises, so a late read only delays a phase
exit, and an iteration with no live slot changes nothing and is not
counted.  Nothing inside an iteration waits for the host.  Randomness
comes from one ``torch.Generator``.  The network and the Adam state are
updated in place.

An iteration's sampling and transport (the next sector and direction
from the Q rows, the throughput, the banking of finished samples and the
regeneration) is one launch of ``ops.deep_transport.sample_transport``:
a CUDA kernel on the card, its plain twin on the CPU.  The frame draws
the step's uniforms for it, in the order the twin once drew them.

Tracing (``utils.profiling``), only while a profiler records: spans
``trace_frame_deep_wavefront.<phase>`` (pack: the tables and the tree;
slots: the sector cosines, the camera's origin, the slot state, the image
and the statistics; step: one step of the loop, its iteration count and
tallies around the stages hit, forward, td, train: an iteration's stages;
sample: the draws of the step's uniforms; transport: the
sample-and-transport launch and its outputs; compact and flush: a drain;
capture: an armed step's copies for ``CAPTURE`` (those after each
minibatch lie in ``.train``); totals: the phases' iteration counts and the
counters) and ``render_frame_neural_q_wavefront.assemble`` (and
``render_frame_pretrained_wavefront.assemble``: the image's division and
the aux), the host waits ``sync.live_count`` (the live-count reduction and
read), ``sync.flush`` (the flush's two masked indexes) and ``sync.camera``
(the origin's copy to the card), and the frame's counts
``deep_wavefront.frames``, ``.steps``, ``.transport_launches`` (host: the
steps that went through the kernel) and ``.iterations``, ``.rays``,
``.rows_forwarded`` (device: live iterations, live rays traced, surface
hits forwarded).  Every op of a frame lies inside one of these spans or a
helper's.  A ``Capture`` in the module attribute ``CAPTURE`` keeps chosen
iterations' tensors for a comparison from outside; without one the frame
checks the attribute once a step.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import torch

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import (DeepLearningConfig, RadianceVolumeConfig,
                                    RenderConfig)
from rlrpt_tpu_torch.deep.neural_q import (_generator, _q_forward,
                                           bootstrap_max, decay_epsilon,
                                           f32, train_on_batches)
from rlrpt_tpu_torch.integrators.sarsa_wavefront import (DRAIN_FACTOR,
                                                         INF_CUT,
                                                         MIN_DRAIN_W,
                                                         _compact, _flush,
                                                         _live_above,
                                                         _phase_widths)
from rlrpt_tpu_torch.integrators.sarsa_wavefront import \
    Capture as _SlotCapture
from rlrpt_tpu_torch.integrators.wavefront import _primary_dirs
from rlrpt_tpu_torch.nn.adam import AdamState
from rlrpt_tpu_torch.nn.dq_network import DQNetwork
from rlrpt_tpu_torch.ops.hemisphere import sector_cos_thetas
from rlrpt_tpu_torch.ops.bvh import build_bvh
from rlrpt_tpu_torch.ops.deep_transport import KERNEL as TRANSPORT
from rlrpt_tpu_torch.ops.deep_transport import (Frame, lane_epsilon,
                                               sample_transport)
from rlrpt_tpu_torch.ops.intersect_pallas import (closest_hit_mat_mxu,
                                                  pack_scene_mxu)
from rlrpt_tpu_torch.parallel.mesh import psum
from rlrpt_tpu_torch.scene.scene import Scene
from rlrpt_tpu_torch.utils import profiling

SYNC_EVERY = 2

#: A ``Capture`` armed by a caller that checks chosen iterations from
#: outside the frame (the benchmark's comparison), or None.
CAPTURE = None


class _State(NamedTuple):
    # per slot, sliced at each drain step
    o: torch.Tensor           # (W, 3)
    d: torch.Tensor           # (W, 3)
    tp: torch.Tensor          # (W, 3)
    pixel: torch.Tensor       # (W,) int64 current pixel id
    kmx: torch.Tensor         # (W,) int64 pixel-multiplex index
    bounce: torch.Tensor      # (W,) int32
    remaining: torch.Tensor   # (W,) int32 samples left after the current
    sord: torch.Tensor        # (W,) int32 sample ordinal (epsilon decay)
    active: torch.Tensor      # (W,) bool
    sample_rad: torch.Tensor  # (W, 3)
    slot_rad: torch.Tensor    # (W, pix_mux, 3)
    prev_loc: torch.Tensor    # (W, 3) position of the pending action
    action: torch.Tensor      # (W,) int64, -1 = no pending transition


def flat_state(net: DQNetwork, opt_state: AdamState) -> tuple:
    """A copy of the parameters and the Adam moments, flat in that order
    (each parameter's, then each mu, then each nu), and of the step
    count."""
    parts = [p.detach().reshape(-1) for p in net.parameters()]
    parts += [m.reshape(-1) for m in opt_state.mu]
    parts += [v.reshape(-1) for v in opt_state.nu]
    return torch.cat(parts), opt_state.count.clone()


class Capture(_SlotCapture):
    """What a frame keeps of itself while armed (``CAPTURE``).

    ``iterations``: the frame's steps (counted from 0 over every phase) to
    record; ``tail``: also record the final phase's steps, keeping the last
    SYNC_EVERY (the last step with a live slot is among them).  A record
    is a dict of the step's tensors: its input state ``state`` (a
    ``_State``), the hit (``t``, ``tri``, ``mrow``), the positions
    forwarded ``qpos``, the Q rows ``qs``, the uniforms ``u``, the
    per-lane epsilon ``eps``, the sampler's ``sector`` and ``pdf``, the
    TD targets ``td`` and the ``pending`` mask, the net and Adam state
    before training (``before``: ``flat_state``) and after each of its
    minibatches (``trained``, a list of ``flat_state``), and the output
    state ``out``; plus ``step``, ``phase``, ``width``.  The step's
    tensors are new each step and never written again, so a record holds
    them; the net and the Adam state, trained in place, are copied.
    ``flushes``: every flush's (pixel, kmx, slot_rad) copies, in order;
    ``w0``, the slots; ``steps``, the frame's steps.  The bookkeeping
    (``want``, ``flush``) is the SARSA wavefront's ``Capture``'s."""


def trace_frame_deep_wavefront(generator_or_seed, scene: Scene,
                               camera: Camera, net: DQNetwork,
                               cfg: RenderConfig, rl: RadianceVolumeConfig,
                               dl: DeepLearningConfig, *,
                               opt_state: AdamState | None = None,
                               epsilon: float = 0.0, train: bool = False,
                               pix_mux: int = 1, mlp_dtype: str = "f32",
                               train_batching: str = "minibatch",
                               pix_lo: int = 0,
                               n_pix_local: int | None = None, mesh=None):
    """One regenerative deep frame; returns (image_sum (n_pix_local, 3),
    the pixels from ``pix_lo`` on, stats).

    ``train=False`` freezes the net (pretrained; the caller passes
    epsilon 0); ``train=True`` runs the online TD updates with
    ``opt_state``.  mlp_dtype "bf16" (inference only) runs the forward in
    bfloat16, every operand cast: the sampler's pdf comes from the same
    rounded Q distribution the sector is drawn from, so the estimator
    stays unbiased.  train_batching "minibatch" takes the reference's
    sequential per-batch_size Adam steps each iteration
    (neural_q_pathtracer.cu:421-513); "fused" takes one step over all of
    the iteration's pending transitions.

    stats: path_sum, zclp, loss_sum, td_sq_sum, light_hits,
    light_path_sum (device tensors), phase_iterations (a device tensor),
    phase_widths (ints).

    ``pix_lo`` and ``n_pix_local`` carve out this shard's pixel range
    [pix_lo, pix_lo + n_pix_local) (the whole frame by default).  With a
    ``mesh`` (parallel.mesh) every rank holds its shard (or its own scene)
    and a replica of the net: the gradients, loss and live count are
    summed per minibatch (neural_q.train_on_batches), as is td_sq, and a
    phase ends only when every rank's live count fits the next width, so
    all ranks run the same iterations and minibatches.  The other stats
    stay the rank's own.
    """
    if mlp_dtype not in ("f32", "bf16"):
        raise ValueError(f"mlp_dtype must be 'f32' or 'bf16', got "
                         f"{mlp_dtype!r}")
    if train_batching not in ("minibatch", "fused"):
        raise ValueError(f"train_batching must be 'minibatch' or 'fused', "
                         f"got {train_batching!r}")
    if train and mlp_dtype != "f32":
        raise ValueError("the bf16 forward is inference only (training "
                         "keeps the reference's f32 numerics)")
    if train and opt_state is None:
        raise ValueError("training needs opt_state")
    device = next(net.parameters()).device
    gen = _generator(generator_or_seed, device)
    span = profiling.span
    counting = profiling.recording()
    rec_ = profiling.RECORDER
    cap = CAPTURE
    with span("trace_frame_deep_wavefront.pack"):
        scene = scene.to(device)
        tris, mat = pack_scene_mxu(scene)
        bvh = build_bvh(tris)   # once a frame, on the table's device
    ns = scene.n_surfaces
    n_pix, spp = cfg.n_pixels, cfg.samples_per_pixel
    n_local = n_pix if n_pix_local is None else n_pix_local
    pix_end = pix_lo + n_local
    gr = rl.grid_resolution
    w0 = -(-n_local // pix_mux)        # slots; slot i owns i + k*w0, k<mux
    f32d = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    fr = Frame(n_surfaces=ns, w0=w0, n_pix=n_pix, pix_end=pix_end,
               pix_mux=pix_mux, spp=spp, camera=camera, cfg=cfg, gr=gr,
               grid_rho=rl.grid_rho,
               epsilon=((f32(epsilon), dl.epsilon_decay, dl.epsilon_min)
                        if train else None))
    launches = TRANSPORT.launches

    with span("trace_frame_deep_wavefront.slots"):
        cos_tbl = sector_cos_thetas(gr, device)
        if mlp_dtype == "bf16":
            fwd_net = copy.deepcopy(net).to(torch.bfloat16)
            verts = scene.vertices_flat.to(torch.bfloat16)
        with profiling.host_sync("camera", tris):
            cam_o = torch.tensor(camera.position, **f32d)
        lane = torch.arange(1, w0 + 1, **i32)
        pix0 = pix_lo + torch.arange(w0, **i64)
        in_image = (pix0 < n_pix) & (pix0 < pix_end)
        st = _State(
            o=cam_o.expand(w0, 3).clone(),
            d=_primary_dirs(gen, pix0, camera, cfg),
            tp=torch.ones((w0, 3), **f32d), pixel=pix0,
            kmx=torch.zeros((w0,), **i64), bounce=torch.zeros((w0,), **i32),
            remaining=torch.where(in_image, spp - 1, 0).to(torch.int32),
            sord=torch.zeros((w0,), **i32), active=in_image,
            sample_rad=torch.zeros((w0, 3), **f32d),
            slot_rad=torch.zeros((w0, pix_mux, 3), **f32d),
            prev_loc=torch.zeros((w0, 3), **f32d),
            action=torch.full((w0,), -1, **i64))
        image = torch.zeros((n_local, 3), **f32d)
        zero = lambda dt: torch.zeros((), dtype=dt, device=device)  # noqa
        stats = {"path_sum": zero(torch.float64), "zclp": zero(torch.int64),
                 "loss_sum": zero(torch.float32),
                 "td_sq_sum": zero(torch.float32),
                 "light_hits": zero(torch.int64),
                 "light_path_sum": zero(torch.float64)}
        no_iters = zero(torch.int64)   # a phase's count starts here

    def step(c: _State, wp: int, rec: dict | None) -> _State:
        act = c.active
        with span("trace_frame_deep_wavefront.hit"):
            # last live lane + 1 (0 when none is live), on the device
            m = torch.max(torch.where(act, lane[:wp], 0)).reshape(1)
            t, tri, mrow = closest_hit_mat_mxu(c.o, c.d, tris, mat, m, bvh)
            lum = mrow[:, 10]
            missed = act & (t >= INF_CUT)
            hit_light = act & ~missed & (tri >= ns)
            hit_surface = act & ~missed & (tri < ns)
            # dead and missed lanes would feed inf into the MLP: clamp them
            qpos = torch.where(hit_surface[:, None], c.o + t[:, None] * c.d,
                               0.0)
        if counting:
            rec_.tally("deep_wavefront.rays", act.sum())
            rec_.tally("deep_wavefront.rows_forwarded", hit_surface.sum())

        # ONE forward: the sampling distribution and the TD bootstrap
        with span("trace_frame_deep_wavefront.forward"), torch.no_grad():
            if mlp_dtype == "bf16":
                if dl.train_on_position:
                    qs = fwd_net(qpos.to(torch.bfloat16))
                else:
                    qs = fwd_net.forward_relative(verts,
                                                  qpos.to(torch.bfloat16))
                qs = qs.float()
            else:
                qs = _q_forward(net, scene, qpos, dl)

        if train:
            with span("trace_frame_deep_wavefront.td"):
                # rewards and discounts per hit type (neural_q_pathtracer.
                # cu:646-752): light r = lum * 200, miss 0, surface
                # gamma = lum
                td = torch.where(hit_light, lum * dl.light_reward_scale,
                                 torch.where(hit_surface,
                                             lum * bootstrap_max(qs,
                                                                 cos_tbl),
                                             0.0))
                pending = act & (c.action >= 0)
            with span("trace_frame_deep_wavefront.train"):
                dl_t = (dataclasses.replace(dl, batch_size=wp)
                        if train_batching == "fused" else dl)
                on_step = None
                if rec is not None:
                    trained = []
                    with span("trace_frame_deep_wavefront.capture"):
                        rec.update(td=td, pending=pending, trained=trained,
                                   before=flat_state(net, opt_state))

                    def on_step():
                        trained.append(flat_state(net, opt_state))
                stats["loss_sum"] += train_on_batches(
                    net, opt_state, scene, c.prev_loc,
                    torch.clamp(c.action, min=0), td, dl_t,
                    weights=pending.float(), mesh=mesh, on_step=on_step)
                # the loss's scale: squared error grows with Q's magnitude
                # (x200 light reward) even while the relative error falls
                td_sq = torch.where(pending, td * td, 0.0).sum()
                if mesh is not None:
                    td_sq = psum(td_sq.reshape(1), mesh)[0]
                stats["td_sq_sum"] += td_sq

        with span("trace_frame_deep_wavefront.sample"):
            # the step's uniforms: the sampler's, Russian roulette's, the
            # regenerated camera rays' jitter
            u = torch.rand((wp, 5), generator=gen, device=device)
            u_rr = (torch.rand((wp,), generator=gen, device=device)
                    if cfg.russian_roulette else None)
            u_pix = torch.rand((wp, 2), generator=gen, device=device)
        with span("trace_frame_deep_wavefront.transport"):
            out, sector, pdf = sample_transport(c, t, tri, mrow, qpos, qs, u,
                                                u_rr, u_pix, cos_tbl, stats,
                                                fr)
        if rec is not None:
            with span("trace_frame_deep_wavefront.capture"):
                rec.update(state=c, t=t, tri=tri, mrow=mrow, qpos=qpos,
                           qs=qs, u=u, eps=lane_epsilon(c.sord, fr.epsilon),
                           sector=sector, pdf=pdf, out=out, live=act.any())
        return out

    widths = _phase_widths(w0, DRAIN_FACTOR, MIN_DRAIN_W)
    phase_iters = []
    k = 0                     # the frame's steps so far
    if cap is not None:
        cap.w0 = w0
    for i, wp in enumerate(widths):
        w_next = widths[i + 1] if i + 1 < len(widths) else 0
        iters = no_iters
        n = 0
        while n % SYNC_EVERY or _live_above(st.active, w_next, mesh):
            with span("trace_frame_deep_wavefront.step"):
                iters = iters + st.active.any()
                rec = None if cap is None else cap.want(k, w_next == 0)
                if rec is not None:
                    rec.update(step=k, phase=i, width=wp)
                st = step(st, wp, rec)
            n += 1
            k += 1
        phase_iters.append(iters)
        if w_next:
            with span("trace_frame_deep_wavefront.compact"):
                st = _compact(st, wp)
            # the tail [w_next:] is dead: flush its banked radiance before
            # slicing it away
            with span("trace_frame_deep_wavefront.flush"):
                if cap is not None:
                    cap.flush(st.pixel[w_next:], st.kmx[w_next:],
                              st.slot_rad[w_next:])
                with profiling.host_sync("flush", image, waits=2):
                    _flush(image, st.pixel[w_next:], st.kmx[w_next:],
                           st.slot_rad[w_next:], w0, pix_lo)
                st = _State(*(a[:w_next] for a in st))
    with span("trace_frame_deep_wavefront.flush"):
        if cap is not None:
            cap.flush(st.pixel, st.kmx, st.slot_rad)
        with profiling.host_sync("flush", image, waits=2):
            _flush(image, st.pixel, st.kmx, st.slot_rad, w0, pix_lo)
    with span("trace_frame_deep_wavefront.totals"):
        stats.update(phase_iterations=torch.stack(phase_iters),
                     phase_widths=tuple(widths))
        if counting:
            rec_.counts["deep_wavefront.frames"] += 1
            rec_.counts["deep_wavefront.steps"] += k
            rec_.counts["deep_wavefront.transport_launches"] += (
                TRANSPORT.launches - launches)
            rec_.tally("deep_wavefront.iterations",
                       stats["phase_iterations"].sum())
    if cap is not None:
        cap.steps = k
    return image, stats


def _aux(stats: dict, cfg: RenderConfig) -> dict:
    total = cfg.n_pixels * cfg.samples_per_pixel
    hits = stats["light_hits"]
    return {"avg_path_length": stats["path_sum"] / total,
            "zero_contribution_light_paths": stats["zclp"],
            "wavefront_iterations": stats["phase_iterations"].sum(),
            "phase_iterations": stats["phase_iterations"],
            "phase_widths": stats["phase_widths"],
            "light_hit_fraction": hits / total,
            "avg_light_path_length": stats["light_path_sum"]
            / torch.clamp(hits, min=1)}


def render_frame_pretrained_wavefront(generator_or_seed, scene: Scene,
                                      camera: Camera, net: DQNetwork,
                                      cfg: RenderConfig,
                                      rl: RadianceVolumeConfig,
                                      dl: DeepLearningConfig,
                                      pix_mux: int = 8,
                                      mlp_dtype: str = "f32"):
    """Inference with a frozen net, epsilon 0 (ref: pre_trained_
    pathtracer.cu:286); returns (image (H, W, 3), aux)."""
    image_sum, stats = trace_frame_deep_wavefront(
        generator_or_seed, scene, camera, net, cfg, rl, dl, train=False,
        pix_mux=pix_mux, mlp_dtype=mlp_dtype)
    with profiling.span("render_frame_pretrained_wavefront.assemble"):
        img = (image_sum / cfg.samples_per_pixel).reshape(
            cfg.height, cfg.width, 3)
        return img, _aux(stats, cfg)


def render_frame_neural_q_wavefront(generator_or_seed, scene: Scene,
                                    camera: Camera, net: DQNetwork,
                                    opt_state: AdamState, epsilon: float,
                                    cfg: RenderConfig,
                                    rl: RadianceVolumeConfig,
                                    dl: DeepLearningConfig, pix_mux: int = 8,
                                    train_batching: str = "minibatch"):
    """Online training frame; returns (image, net, opt_state, epsilon
    advanced by spp decays, aux).  aux holds frame totals (the lockstep
    reports per-spp arrays): loss, loss_rel = loss / sum(td^2) (the
    scale-free training error), td_sq, and the pretrained frame's keys."""
    image_sum, stats = trace_frame_deep_wavefront(
        generator_or_seed, scene, camera, net, cfg, rl, dl,
        opt_state=opt_state, epsilon=epsilon, train=True, pix_mux=pix_mux,
        train_batching=train_batching)
    with profiling.span("render_frame_neural_q_wavefront.assemble"):
        img = (image_sum / cfg.samples_per_pixel).reshape(
            cfg.height, cfg.width, 3)
        aux = _aux(stats, cfg)
        aux.update(loss=stats["loss_sum"],
                   loss_rel=stats["loss_sum"]
                   / torch.clamp(stats["td_sq_sum"], min=1e-12),
                   td_sq=stats["td_sq_sum"])
    eps_next = decay_epsilon(epsilon, cfg.samples_per_pixel, dl)
    return img, net, opt_state, eps_next, aux
