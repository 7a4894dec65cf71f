"""One step's sample-and-transport of the deep-Q wavefront
(``deep.deep_wavefront.trace_frame_deep_wavefront``), as one CUDA kernel,
``csrc/deep_transport.cu``.

``sample_transport`` takes a step after its hit and its forward: the
step's input slot state (the frame's ``_State``), the hit (``t``, ``tri``,
``mrow``), the positions forwarded ``qpos``, the Q rows ``qs`` (W, S) f32,
the step's uniforms, the sector cosines and the frame's constants
(``Frame``).  It returns the new slot state, the sector and the pdf, all
newly allocated, and adds into the frame's four statistics (``path_sum``,
``light_path_sum``, ``zclp``, ``light_hits``) in place.

The caller draws the uniforms, in the order the twin once drew them
itself: ``u`` (W, 5) for the sampler (``deep.neural_q.
sample_q_directions_u``), ``u_rr`` (W,) for Russian roulette (None when
the configuration has none), and ``u_pix`` (W, 2), the jitter of the
regenerated camera rays.  So the kernel and the twin read the same random
numbers, and the frame's stream of them is what it was.

The wrapper launches the kernel for CUDA tensors and runs the plain twin
``sample_transport_plain`` (the frame's former torch code of the two
stages) for CPU tensors; it raises for any other device and for inputs the
kernel does not take.  ``KERNEL.launches`` counts the launches.  The
kernel replaces no TPU kernel: the JAX package leaves these stages to XLA.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from rlrpt_tpu_torch import _cuda
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RHO, RenderConfig
from rlrpt_tpu_torch.deep.neural_q import sample_q_directions_u
from rlrpt_tpu_torch.integrators.sarsa_wavefront import INF_CUT
from rlrpt_tpu_torch.integrators.wavefront import primary_dirs_u

# A block's 128 Q rows sit in shared memory (227 KB a block at most).
MAX_SECTORS = 441

SLOT_FIELDS = ("o", "d", "tp", "pixel", "kmx", "bounce", "remaining", "sord",
               "active", "sample_rad", "slot_rad", "prev_loc", "action")
STATS = ("path_sum", "light_path_sum", "zclp", "light_hits")


class DeepParams(ctypes.Structure):
    """Mirror of ``DeepParams`` in csrc/deep_transport.cu (4-byte
    fields)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "n_lanes", "n_sectors", "grid", "n_surfaces", "w0", "n_pix",
        "pix_end", "pix_mux", "spp", "width", "max_bounces",
        "russian_roulette", "rr_start_bounce", "train", "scan_levels")] + [
        (name, ctypes.c_float) for name in (
            "env", "ray_eps", "rr_min_prob", "throughput_threshold", "eps0",
            "eps_decay", "eps_min", "rho", "inv_grid_rho", "inv_sectors",
            "inv_pi", "inv_grid",
            "half_width", "half_height", "focal", "cam_x", "cam_y", "cam_z",
            "cos_yaw_y", "sin_yaw_y", "cos_yaw_x", "sin_yaw_x")]


class SlotState(ctypes.Structure):
    """Mirror of ``SlotState``: a slot state's field pointers."""

    _fields_ = [(name, ctypes.c_void_p) for name in SLOT_FIELDS]


class StepInputs(ctypes.Structure):
    """Mirror of ``StepInputs``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "t", "tri", "mrow", "qpos", "qs", "u", "u_rr", "u_pix", "cos")]


class StepOutputs(ctypes.Structure):
    """Mirror of ``StepOutputs``."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("sector", "pdf")
                + STATS]


KERNEL = _cuda.Kernel("rlrpt_deep_transport",
                      [DeepParams, SlotState, StepInputs, SlotState,
                       StepOutputs, ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class Frame:
    """A frame's constants of the step: the scene's surface count, the
    slots ``w0``, the image's pixels ``n_pix``, the end of this shard's
    pixels ``pix_end``, pixels a slot, samples a pixel, the camera, the
    render configuration, the sector grid and its GRID_RHO, and
    ``epsilon``: (epsilon, its decay a sample, its floor) while the net
    trains, None for a frozen net (epsilon 0)."""

    n_surfaces: int
    w0: int
    n_pix: int
    pix_end: int
    pix_mux: int
    spp: int
    camera: Camera
    cfg: RenderConfig
    gr: int
    grid_rho: float
    epsilon: tuple | None

    @functools.cached_property
    def params(self) -> DeepParams:
        """The kernel's parameters, but for ``n_lanes`` and ``scan_levels``,
        which the wrapper sets a launch."""
        cfg, cam = self.cfg, self.camera
        eps0, decay, eps_min = self.epsilon or (0.0, 0.0, 0.0)
        cy, sy, cx, sx = cam.yaw_cos_sin()
        return DeepParams(
            n_lanes=0, n_sectors=self.gr * self.gr, grid=self.gr,
            n_surfaces=self.n_surfaces, w0=self.w0, n_pix=self.n_pix,
            pix_end=self.pix_end, pix_mux=self.pix_mux, spp=self.spp,
            width=cfg.width, max_bounces=cfg.max_ray_bounces,
            russian_roulette=int(cfg.russian_roulette),
            rr_start_bounce=cfg.rr_start_bounce,
            train=int(self.epsilon is not None),
            env=cfg.environment_light, ray_eps=cfg.eps,
            rr_min_prob=cfg.rr_min_prob,
            throughput_threshold=cfg.throughput_threshold, eps0=eps0,
            eps_decay=decay, eps_min=eps_min, rho=RHO,
            inv_grid_rho=_reciprocal(self.grid_rho),
            inv_sectors=1.0 / (self.gr * self.gr),
            inv_pi=_reciprocal(math.pi), inv_grid=_reciprocal(self.gr),
            half_width=cfg.width / 2.0,
            half_height=cfg.height / 2.0, focal=cfg.focal,
            cam_x=cam.position[0], cam_y=cam.position[1],
            cam_z=cam.position[2], cos_yaw_y=cy, sin_yaw_y=sy, cos_yaw_x=cx,
            sin_yaw_x=sx)


def scan_levels(rows: int, row_size: int) -> int:
    """log2 of the columns torch.cumsum's kernel on the card scans at a
    time along the last dimension of a contiguous (rows, row_size) f32
    tensor: 2 x its threads a row, from ATen's
    get_log_num_threads_x_inner_scan (ATen/native/cuda/ScanUtils.cuh), in
    that function's uint32 arithmetic."""
    lx, ly = (row_size - 1).bit_length(), (rows - 1).bit_length()
    return min(max(4, ((9 + lx - ly) % 2**32) // 2), 9) + 1


def _reciprocal(x: float) -> float:
    """1 / f32(x) in f32: torch divides a tensor by a host scalar on the
    card as a product with this."""
    return float(np.float32(1.0) / np.float32(x))


def lane_epsilon(sord: torch.Tensor, epsilon: tuple | None):
    """Each lane's epsilon, max(eps0 - decay * sord, eps_min) in f32, or
    0.0 for a frozen net (``epsilon`` None)."""
    if epsilon is None:
        return 0.0
    eps0, decay, eps_min = epsilon
    return torch.clamp(eps0 - decay * sord.float(), min=eps_min)


def sample_transport_plain(c, t, tri, mrow, qpos, qs, u, u_rr, u_pix, cos,
                           stats: dict, fr: Frame):
    """The plain torch twin of the kernel: ``sample_transport``'s
    arguments and results."""
    cfg, device = fr.cfg, c.o.device
    act = c.active
    normal, diffuse3, emission3 = mrow[:, 0:3], mrow[:, 3:6], mrow[:, 6:9]
    missed = act & (t >= INF_CUT)
    hit_light = act & ~missed & (tri >= fr.n_surfaces)
    hit_surface = act & ~missed & (tri < fr.n_surfaces)
    contrib = (torch.where(missed[:, None], c.tp * cfg.environment_light, 0.0)
               + torch.where(hit_light[:, None], c.tp * emission3, 0.0))

    # the next direction from Q * cos
    new_d, sector, pdf = sample_q_directions_u(
        u, qs, normal, lane_epsilon(c.sord, fr.epsilon), fr.gr, fr.grid_rho,
        cos)

    cos_theta = torch.sum(normal * new_d, dim=-1)
    brdf3 = diffuse3 / math.pi
    pdf_safe = torch.clamp(pdf, min=1e-12)
    exhausted = hit_surface & (c.bounce + 1 >= cfg.max_ray_bounces)
    survive = hit_surface & ~exhausted
    # the bounce cap contributes tp * brdf, no direction factor
    sample_rad = (c.sample_rad + contrib
                  + torch.where(exhausted[:, None], c.tp * brdf3, 0.0))
    tp = torch.where(survive[:, None],
                     c.tp * brdf3 * (cos_theta / pdf_safe)[:, None], c.tp)
    rr_killed = torch.zeros_like(survive)
    if cfg.russian_roulette:
        p = torch.clamp(tp.max(dim=-1).values, cfg.rr_min_prob, 1.0)
        do_rr = survive & (c.bounce + 1 >= cfg.rr_start_bounce)
        rr_killed = do_rr & (u_rr >= p)
        tp = torch.where((do_rr & ~rr_killed)[:, None], tp / p[:, None], tp)
        survive = survive & ~rr_killed

    o = torch.where(survive[:, None], qpos + cfg.eps * new_d, c.o)
    d = torch.where(survive[:, None], new_d, c.d)
    bounce = torch.where(survive, c.bounce + 1, c.bounce)
    prev_loc = torch.where(survive[:, None], qpos, c.prev_loc)
    action = torch.where(survive, sector, -1)

    # stats of finished samples
    done = missed | hit_light
    fin = (bounce + 1).double()
    stats["path_sum"] += (torch.where(done | rr_killed, fin, 0.0).sum()
                          + exhausted.sum().double() * cfg.max_ray_bounces)
    finished = act & ~survive
    stats["zclp"] += (finished & (sample_rad.mean(-1)
                                  < cfg.throughput_threshold)).sum()
    # guidance shows on the light-terminated subset: the Cornell box is
    # open at the camera side, so better guidance turns short escaping
    # paths into longer light-finding ones
    stats["light_hits"] += hit_light.sum()
    stats["light_path_sum"] += torch.where(hit_light, fin, 0.0).sum()

    # bank finished samples into the slot's k-th row
    ksel_base = torch.arange(fr.pix_mux, device=device)
    slot_rad = c.slot_rad + (
        (ksel_base == c.kmx[:, None])[:, :, None]
        * torch.where(finished[:, None], sample_rad, 0.0)[:, None, :])

    # regeneration: the next sample, else the next multiplexed pixel
    next_pix = c.pixel + fr.w0
    step_k = (finished & (c.remaining <= 0) & (c.kmx + 1 < fr.pix_mux)
              & (next_pix < fr.n_pix) & (next_pix < fr.pix_end))
    pixel = torch.where(step_k, next_pix, c.pixel)
    kmx = torch.where(step_k, c.kmx + 1, c.kmx)
    remaining = torch.where(step_k, fr.spp, c.remaining)
    regen = finished & (remaining > 0)
    rd = primary_dirs_u(u_pix, pixel, fr.camera, cfg)
    cam_o = torch.tensor(fr.camera.position, dtype=torch.float32,
                         device=device)
    # a pixel's next sample advances its ordinal, a new pixel resets it
    sord = torch.where(regen, torch.where(step_k, 0, c.sord + 1), c.sord)
    out = type(c)(
        o=torch.where(regen[:, None], cam_o, o),
        d=torch.where(regen[:, None], rd, d),
        tp=torch.where(regen[:, None], 1.0, tp), pixel=pixel,
        kmx=kmx, bounce=torch.where(regen, 0, bounce),
        remaining=torch.where(regen, remaining - 1, remaining),
        sord=sord, active=survive | regen,
        sample_rad=torch.where(regen[:, None], 0.0, sample_rad),
        slot_rad=slot_rad, prev_loc=prev_loc,
        action=torch.where(regen, -1, action))
    return out, sector, pdf


def _check(c, t, tri, mrow, qpos, qs, u, u_rr, u_pix, cos, stats, fr):
    if tuple(type(c)._fields) != SLOT_FIELDS:
        raise ValueError(f"the slot state's fields must be {SLOT_FIELDS}")
    w, s = c.o.shape[0], fr.gr * fr.gr
    if s > MAX_SECTORS:
        raise ValueError(f"at most {MAX_SECTORS} sectors, got {s}")
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    want = [("o", c.o, f32, (w, 3)), ("d", c.d, f32, (w, 3)),
            ("tp", c.tp, f32, (w, 3)), ("pixel", c.pixel, i64, (w,)),
            ("kmx", c.kmx, i64, (w,)), ("bounce", c.bounce, i32, (w,)),
            ("remaining", c.remaining, i32, (w,)),
            ("sord", c.sord, i32, (w,)),
            ("active", c.active, torch.bool, (w,)),
            ("sample_rad", c.sample_rad, f32, (w, 3)),
            ("slot_rad", c.slot_rad, f32, (w, fr.pix_mux, 3)),
            ("prev_loc", c.prev_loc, f32, (w, 3)),
            ("action", c.action, i64, (w,)), ("t", t, f32, (w,)),
            ("tri", tri, i32, (w,)), ("mrow", mrow, f32, (w, 16)),
            ("qpos", qpos, f32, (w, 3)), ("qs", qs, f32, (w, s)),
            ("u", u, f32, (w, 5)), ("u_pix", u_pix, f32, (w, 2)),
            ("cos", cos, f32, (s,))]
    want += [(k, stats[k], dt, ()) for k, dt in zip(
        STATS, (torch.float64, torch.float64, i64, i64))]
    if fr.cfg.russian_roulette:
        want.append(("u_rr", u_rr, f32, (w,)))
    elif u_rr is not None:
        raise ValueError("u_rr is for Russian roulette, which the "
                         "configuration turns off: pass None")
    dev = c.o.device
    for name, a, dt, shape in want:
        if a is None:
            raise ValueError(f"{name} is missing")
        if a.dtype != dt or a.shape != shape:
            raise ValueError(f"{name} must be {dt} {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
        if a.device != dev:
            raise ValueError(f"{name} must be on the state's device {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mrow.data_ptr() % 16:
        raise ValueError("mrow must be 16-byte aligned (float4 loads)")


def sample_transport(c, t, tri, mrow, qpos, qs, u, u_rr, u_pix, cos,
                     stats: dict, fr: Frame):
    """One step's sample-and-transport (the module's docstring); returns
    (the new slot state, sector (W,) int64, pdf (W,) f32)."""
    _check(c, t, tri, mrow, qpos, qs, u, u_rr, u_pix, cos, stats, fr)
    dev = c.o.device
    if dev.type == "cpu":
        return sample_transport_plain(c, t, tri, mrow, qpos, qs, u, u_rr,
                                      u_pix, cos, stats, fr)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    w = c.o.shape[0]
    out = type(c)(*(torch.empty_like(a) for a in c))
    sector = torch.empty((w,), dtype=torch.int64, device=dev)
    pdf = torch.empty((w,), dtype=torch.float32, device=dev)
    if w:
        p = fr.params
        p.n_lanes, p.scan_levels = w, scan_levels(w, fr.gr * fr.gr)
        ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
        with torch.cuda.device(dev):
            KERNEL.launch(
                p, SlotState(*map(ptr, c)),
                StepInputs(*map(ptr, (t, tri, mrow, qpos, qs, u, u_rr,
                                      u_pix, cos))),
                SlotState(*map(ptr, out)),
                StepOutputs(sector.data_ptr(), pdf.data_ptr(),
                            *(stats[k].data_ptr() for k in STATS)),
                torch.cuda.current_stream().cuda_stream)
    return out, sector, pdf
