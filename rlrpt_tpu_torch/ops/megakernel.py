"""The default path-tracing megakernel (counterpart of
``rlrpt_tpu/ops/megakernel.py``).

One launch renders a whole frame: every ray slot walks its own
regenerative bounce loop — jittered primary ray, closest hit, uniform
hemisphere bounce with throughput *= diffuse * 2cos, emission on a light
hit, env on a miss, the bounce cap, optional Russian roulette on RNG
stream 4 — and slot s owns pixels s + k*n_slots (k < pix_mux).  All
randomness is the counter hash ``_uniform`` keyed on (seed, pixel,
iteration, stream), so for the same int seed, ``n_slots`` and ``pix_mux``
this port draws the JAX kernel's samples and matches its image per pixel
up to f32 rounding.

Two implementations of one frame function:

* ``mega_default_frame`` — the wrapper of the CUDA kernel B1
  (``csrc/mega_default.cu``).  On a CUDA tensor it launches the kernel
  (or raises); on a CPU tensor it runs the plain twin.
* ``mega_default_frame_plain`` — the plain torch twin: the same step
  algebra, vectorised over slots.  The CPU tests and chip_smoke.py hold
  the kernel against it.

The TPU-only parts of the JAX kernel do not carry over: the
(4T, 16) @ (16, R) MXU reformulation of Moller-Trumbore and its
compensated-bf16 operands, the one-hot material fetch, the AABB chunk
cull and the VMEM-driven tile sizes.  A hit here is exact f32
Moller-Trumbore, and a material row is a load.
"""

from __future__ import annotations

import ctypes
import math

import torch

from rlrpt_tpu_torch import _cuda
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RenderConfig
from rlrpt_tpu_torch.scene.scene import Scene

INF = 3.0e38
PI = math.pi
T_CHUNK = 256      # the JAX kernel's triangle chunk; fixes t_pad only

# Slot geometry.  n_slots = ceil(n_pix / pix_mux / r_tile) * r_tile fixes
# which pixels share a slot (pixel = slot + k*n_slots), so r_tile and
# pix_mux shape the image's RNG draws; the CUDA block size is separate.
# The JAX bench point uses r_tile 1024 / pix_mux 32: 16,384 slots at
# 720x720, enough for one TPU core but a small fraction of the H100's
# 132 SMs x 2048 resident threads.  The GPU default gives every pixel its
# own slot: 518,400 threads at 720x720.
R_TILE = 128
PIX_MUX = 1

_M32 = 0xFFFFFFFF


def _t_pad(n_tris: int) -> int:
    """Padded triangle count of the JAX kernel's tables (megakernel.py:79)
    — TriBinCDF tables are laid out for it."""
    t8 = max(8, int(math.ceil(n_tris / 8) * 8))
    return min(T_CHUNK, t8) if t8 <= T_CHUNK else int(
        math.ceil(n_tris / T_CHUNK) * T_CHUNK)


def n_slots_for(n_pix: int, r_tile: int, pix_mux: int) -> int:
    return int(math.ceil(n_pix / pix_mux / r_tile) * r_tile)


# ---- counter PRNG ---------------------------------------------------------
# The arithmetic is uint32 held in int64 tensors and masked to 32 bits:
# torch's >> on int32 is arithmetic, the JAX kernel's shifts are logical.

def _mul32(x, c: int):
    """(x * c) mod 2^32 for 0 <= x < 2^32 without int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _hash32(x):
    """lowbias32 integer finalizer on uint32 values (megakernel.py:194)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _uniform(seed: int, pix, it, stream: int) -> torch.Tensor:
    """float32 uniforms in [0, 1) keyed on (seed, pixel, iteration, stream):
    the top 24 bits of the hash times 2^-24 (megakernel.py:208)."""
    pix = torch.as_tensor(pix, dtype=torch.int64)
    x = (int(seed) + _mul32(pix & _M32, 0x9E3779B9)
         + _mul32(torch.as_tensor(it, dtype=torch.int64) & _M32, 0x85EBCA6B)
         + ((stream * 0xC2B2AE35) & _M32)) & _M32
    return (_hash32(x) >> 8).to(torch.float32) * (1.0 / 16777216.0)


# ---- scene and camera packing ---------------------------------------------

def pack_scene(scene: Scene):
    """Kernel tables: tris (T, 12) f32 rows [v0, 0, e1, 0, e2, 0] and mat
    (T, 16) f32 rows [normal(3), diffuse(3), emission(3), is_light,
    luminance, triangle id, 0 x 4] — the material rows of the JAX
    ``mt_tables`` with row 11 the id the guided kernel keys on."""
    t = scene.n_triangles
    dev = scene.device
    v0 = scene.v0.float()
    zero = torch.zeros((t, 1), dtype=torch.float32, device=dev)
    tris = torch.cat([v0, zero, scene.v1.float() - v0, zero,
                      scene.v2.float() - v0, zero], dim=1).contiguous()
    ids = torch.arange(t, device=dev)
    mat = torch.cat([
        scene.normal.float(), scene.diffuse_c.float(), scene.emission.float(),
        (ids >= scene.n_surfaces).float()[:, None],
        scene.luminance.float()[:, None], ids.float()[:, None],
        torch.zeros((t, 4), dtype=torch.float32, device=dev)],
        dim=1).contiguous()
    return tris, mat


def camera_vector(camera: Camera) -> tuple:
    """(x, y, z, cos yaw_y, sin yaw_y, cos yaw_x, sin yaw_x) as float32
    values held in Python floats (the JAX kernel's `cam` row)."""
    return camera.position + camera.yaw_cos_sin()


def _primary(pix, u1, u2, cam, width: int, height: int, focal: float):
    """Jittered camera ray through pixel `pix` (megakernel.py:221)."""
    _, _, _, cy, sy, cx, sx = cam
    fpy = torch.div(pix, width, rounding_mode="floor")
    fpx = (pix - fpy * width).to(torch.float32)
    fpy = fpy.to(torch.float32)
    dx = fpx + u1 - float(width / 2.0)
    dy = fpy + u2 - float(height / 2.0)
    dz = torch.full_like(dx, focal)
    inv = torch.rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv, dy * inv, dz * inv
    x1 = cy * dx - sy * dz
    z1 = sy * dx + cy * dz
    return x1, cx * dy + sx * z1, -sx * dy + cx * z1


def _frame_tb(nx, ny, nz):
    """Tangent T and bitangent B = N x T of the (T, N, B) frame."""
    zero = torch.zeros_like(nx)
    use_x = torch.abs(nx) > torch.abs(ny)
    tx = torch.where(use_x, nz, zero)
    ty = torch.where(use_x, zero, -nz)
    tz = torch.where(use_x, -nx, ny)
    tn = torch.rsqrt(torch.clamp(tx * tx + ty * ty + tz * tz, min=1e-30))
    tx, ty, tz = tx * tn, ty * tn, tz * tn
    return (tx, ty, tz), (ny * tz - nz * ty, nz * tx - nx * tz,
                          nx * ty - ny * tx)


def _uniform_hemisphere_dir(u1, u2, nx, ny, nz):
    """Uniform hemisphere about n, cos(theta) = u1 (megakernel.py:288):
    world = lx*B + cos*N + lz*T."""
    sint = torch.sqrt(torch.clamp(1.0 - u1 * u1, min=0.0))
    phi = float(2.0 * PI) * u2
    lx, lz = sint * torch.cos(phi), sint * torch.sin(phi)
    (tx, ty, tz), (bx, by, bz) = _frame_tb(nx, ny, nz)
    return (lx * bx + u1 * nx + lz * tx, lx * by + u1 * ny + lz * ty,
            lx * bz + u1 * nz + lz * tz)


# ---- the plain twin: the slot loop vectorised over slots ------------------

def closest_hit_mt(ox, oy, oz, dx, dy, dz, tris):
    """Exact f32 Moller-Trumbore over every (ray, triangle) pair, with the
    kernel's algebra: sign tests multiplied through by det, t = t'/det.

    Returns (t (R,), tri (R,), u' (R,), v' (R,), det (R,)) of the closest
    hit; the first-tested triangle wins ties; misses give t = INF and
    u' = v' = det = 0.
    """
    col = lambda j: tris[:, j][None, :]  # noqa: E731
    v0x, v0y, v0z = col(0), col(1), col(2)
    e1x, e1y, e1z = col(4), col(5), col(6)
    e2x, e2y, e2z = col(8), col(9), col(10)
    ox, oy, oz = ox[:, None], oy[:, None], oz[:, None]
    dx, dy, dz = dx[:, None], dy[:, None], dz[:, None]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    up = tx * px + ty * py + tz * pz
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vp = dx * qx + dy * qy + dz * qz
    tp = e2x * qx + e2y * qy + e2z * qz
    a, b = up * det, vp * det
    valid = (a >= 0.0) & (b >= 0.0) & (a + b <= det * det) & (tp * det > 0.0)
    tt = torch.where(valid, tp / det, torch.full_like(tp, INF))
    best_t, tri = torch.min(tt, dim=1)
    hit = best_t < INF
    pick = lambda q: torch.where(  # noqa: E731
        hit, q.gather(1, tri[:, None])[:, 0], torch.zeros_like(best_t))
    return best_t, tri, pick(up), pick(vp), pick(det)


def run_slots_plain(seed: int, cam: tuple, tris: torch.Tensor,
                    mat: torch.Tensor, cfg: RenderConfig, n_slots: int,
                    pix_mux: int, sample, on_step=None):
    """The regenerative slot loop of the kernels (csrc/path_common.cuh:
    run_slots, advance), vectorised over slots: every step advances every
    active slot by one bounce.  ``sample(pix, it1, u1, u2, hit, nx, ny,
    nz)`` returns (dx, dy, dz, scale, info) for surface hits, ``info``
    whatever the sampler reports of its draw.  ``on_step(act, m, missed,
    hit_light, survive, info)``, if given, sees every step after
    the bounce cap and Russian roulette (``survive``: the path goes on);
    it must not change the path state.

    Returns rad (pix_mux, n_slots, 3), path_sum (n_slots,) f32 and iters
    (n_slots,) i32: per slot, the iteration at which it went idle.
    """
    dev = tris.device
    n_pix, spp = cfg.n_pixels, cfg.samples_per_pixel
    w, h, focal = cfg.width, cfg.height, cfg.focal
    slot = torch.arange(n_slots, dtype=torch.int64, device=dev)
    in_image = slot < n_pix
    f32 = dict(dtype=torch.float32, device=dev)

    dx, dy, dz = _primary(slot, _uniform(seed, slot, 0, 2),
                          _uniform(seed, slot, 0, 3), cam, w, h, focal)
    ox = torch.full((n_slots,), cam[0], **f32)
    oy = torch.full((n_slots,), cam[1], **f32)
    oz = torch.full((n_slots,), cam[2], **f32)
    tr, tg, tb = (torch.ones((n_slots,), **f32) for _ in range(3))
    path_sum = torch.zeros((n_slots,), **f32)
    bounce = torch.zeros_like(slot)
    remaining = torch.where(in_image, spp - 1, 0)
    act = in_image.clone()
    pix = slot.clone()
    kmx = torch.zeros_like(slot)
    rad = torch.zeros((pix_mux, n_slots, 3), **f32)
    iters = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
    it = 0
    while bool(act.any()):
        it1 = it + 1
        u1, u2, u3, u4 = (_uniform(seed, pix, it1, s) for s in range(4))
        hit = closest_hit_mt(ox, oy, oz, dx, dy, dz, tris)
        best_t, tri = hit[0], hit[1]
        m = mat[tri]
        missed = act & (best_t >= INF)
        hit_any = act & ~missed
        hit_light = hit_any & (m[:, 9] > 0.5)
        hit_surface = hit_any & ~hit_light

        # terminal contribution to the slot's current pixel
        thr = torch.stack([tr, tg, tb], dim=1)
        contrib = torch.where(
            missed[:, None], thr * cfg.environment_light,
            torch.where(hit_light[:, None], thr * m[:, 6:9], 0.0))
        rad[kmx, slot] += contrib

        exhausted = hit_surface & (bounce + 1 >= cfg.max_ray_bounces)
        survive = hit_surface & ~exhausted
        sdx, sdy, sdz, scale, info = sample(pix, it1, u1, u2, hit,
                                            m[:, 0], m[:, 1], m[:, 2])
        tr = torch.where(survive, tr * m[:, 3] * scale, tr)
        tg = torch.where(survive, tg * m[:, 4] * scale, tg)
        tb = torch.where(survive, tb * m[:, 5] * scale, tb)

        rr_killed = torch.zeros_like(survive)
        if cfg.russian_roulette:
            u5 = _uniform(seed, pix, it1, 4)
            p = torch.clamp(torch.maximum(tr, torch.maximum(tg, tb)),
                            cfg.rr_min_prob, 1.0)
            do_rr = survive & (bounce + 1 >= cfg.rr_start_bounce)
            rr_killed = do_rr & (u5 >= p)
            keep = do_rr & ~rr_killed
            inv_p = 1.0 / p
            tr = torch.where(keep, tr * inv_p, tr)
            tg = torch.where(keep, tg * inv_p, tg)
            tb = torch.where(keep, tb * inv_p, tb)
            survive = survive & ~rr_killed
        if on_step is not None:
            on_step(act, m, missed, hit_light, survive, info)

        ox = torch.where(survive, ox + best_t * dx + cfg.eps * sdx, ox)
        oy = torch.where(survive, oy + best_t * dy + cfg.eps * sdy, oy)
        oz = torch.where(survive, oz + best_t * dz + cfg.eps * sdz, oz)
        dx = torch.where(survive, sdx, dx)
        dy = torch.where(survive, sdy, dy)
        dz = torch.where(survive, sdz, dz)

        done = missed | hit_light | rr_killed
        path_sum = path_sum + torch.where(done, (bounce + 1).float(), 0.0)
        path_sum = path_sum + torch.where(exhausted,
                                          float(cfg.max_ray_bounces), 0.0)
        bounce = torch.where(survive, bounce + 1, bounce)

        # regeneration: next sample of the current pixel, else the slot's
        # next multiplexed pixel, else go idle
        freed = act & ~survive
        next_pix = pix + n_slots
        step_k = (freed & (remaining <= 0) & (kmx + 1 < pix_mux)
                  & (next_pix < n_pix))
        pix = torch.where(step_k, next_pix, pix)
        kmx = torch.where(step_k, kmx + 1, kmx)
        remaining = torch.where(step_k, spp, remaining)
        regen = freed & (remaining > 0)
        pdx, pdy, pdz = _primary(pix, u3, u4, cam, w, h, focal)
        ox = torch.where(regen, cam[0], ox)
        oy = torch.where(regen, cam[1], oy)
        oz = torch.where(regen, cam[2], oz)
        dx = torch.where(regen, pdx, dx)
        dy = torch.where(regen, pdy, dy)
        dz = torch.where(regen, pdz, dz)
        tr = torch.where(regen, 1.0, tr)
        tg = torch.where(regen, 1.0, tg)
        tb = torch.where(regen, 1.0, tb)
        bounce = torch.where(regen, 0, bounce)
        remaining = torch.where(regen, remaining - 1, remaining)
        new_act = survive | regen
        iters = torch.where(act & ~new_act, it1, iters)
        act = new_act
        it = it1
    return rad, path_sum, iters


def _uniform_sampler(pix, it1, u1, u2, hit, nx, ny, nz):
    dx, dy, dz = _uniform_hemisphere_dir(u1, u2, nx, ny, nz)
    return dx, dy, dz, 2.0 * u1, None


def mega_default_frame_plain(seed: int, cam: tuple, tris: torch.Tensor,
                             mat: torch.Tensor, cfg: RenderConfig,
                             n_slots: int, pix_mux: int):
    """Plain torch twin of kernel B1 on the same inputs."""
    return run_slots_plain(seed, cam, tris, mat, cfg, n_slots, pix_mux,
                           _uniform_sampler)


# ---- the CUDA wrapper -----------------------------------------------------

KERNEL = _cuda.Kernel("rlrpt_mega_default",
                      [_cuda.MegaParams] + [ctypes.c_void_p] * 6)


def check_tables(tris: torch.Tensor, mat: torch.Tensor) -> None:
    t = tris.shape[0]
    if tris.shape != (t, 12) or mat.shape != (t, 16):
        raise ValueError(f"tables must be (T, 12) and (T, 16), got "
                         f"{tuple(tris.shape)} and {tuple(mat.shape)}")
    for name, a in (("tris", tris), ("mat", mat)):
        if a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if a.device != tris.device:
            raise ValueError("tris and mat must be on one device")
    if tris.data_ptr() % 16:
        raise ValueError("tris must be 16-byte aligned (float4 loads)")


def mega_params(seed: int, cam: tuple, n_tris: int, cfg: RenderConfig,
                n_slots: int, pix_mux: int, **guided) -> _cuda.MegaParams:
    if not 0 <= int(seed) < 2 ** 32:
        raise ValueError(f"seed must be a uint32, got {seed}")
    return _cuda.MegaParams(
        seed=int(seed), width=cfg.width, height=cfg.height,
        n_pix=cfg.n_pixels, spp=cfg.samples_per_pixel,
        max_bounces=cfg.max_ray_bounces, pix_mux=pix_mux, n_slots=n_slots,
        n_tris=n_tris, russian_roulette=int(cfg.russian_roulette),
        rr_start_bounce=cfg.rr_start_bounce, focal=cfg.focal,
        env=cfg.environment_light, eps=cfg.eps, rr_min_prob=cfg.rr_min_prob,
        cam_x=cam[0], cam_y=cam[1], cam_z=cam[2], cos_yaw_y=cam[3],
        sin_yaw_y=cam[4], cos_yaw_x=cam[5], sin_yaw_x=cam[6], **guided)


def frame_outputs(n_slots: int, pix_mux: int, device):
    return (torch.empty((pix_mux, n_slots, 3), dtype=torch.float32,
                        device=device),
            torch.empty((n_slots,), dtype=torch.float32, device=device),
            torch.empty((n_slots,), dtype=torch.int32, device=device))


def mega_default_frame(seed: int, cam: tuple, tris: torch.Tensor,
                       mat: torch.Tensor, cfg: RenderConfig, n_slots: int,
                       pix_mux: int):
    """One frame of kernel B1.  Returns (rad (pix_mux, n_slots, 3),
    path_sum (n_slots,), iters (n_slots,)); pixel p's RGB sum is
    rad.reshape(-1, 3)[p].  CPU tensors take the plain twin."""
    check_tables(tris, mat)
    if tris.device.type == "cpu":
        return mega_default_frame_plain(seed, cam, tris, mat, cfg, n_slots,
                                        pix_mux)
    if tris.device.type != "cuda":
        raise ValueError(f"no kernel for device {tris.device}")
    rad, path_sum, iters = frame_outputs(n_slots, pix_mux, tris.device)
    with torch.cuda.device(tris.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(mega_params(seed, cam, tris.shape[0], cfg, n_slots,
                                  pix_mux),
                      tris.data_ptr(), mat.data_ptr(), rad.data_ptr(),
                      path_sum.data_ptr(), iters.data_ptr(), stream)
    return rad, path_sum, iters


def assemble(rad, path_sum, iters, cfg: RenderConfig):
    """Frame outputs -> (image (H, W, 3), aux).  aux values stay 0-d
    device tensors (no host sync).  ``wavefront_iterations`` is the
    per-slot maximum; the JAX kernel reports the per-tile maximum rounded
    up to its unroll factor."""
    n_pix, spp = cfg.n_pixels, cfg.samples_per_pixel
    img = (rad.reshape(-1, 3)[:n_pix] / spp).reshape(cfg.height, cfg.width,
                                                     3)
    aux = {"avg_path_length": path_sum.double().sum() / (n_pix * spp),
           "wavefront_iterations": iters.max()}
    return img, aux


def render_default_mega(seed: int, scene: Scene, camera: Camera,
                        cfg: RenderConfig, device, r_tile: int = R_TILE,
                        pix_mux: int = PIX_MUX):
    """Render a frame with the default megakernel; returns (image, aux).

    ``seed`` is the kernel's int seed: the JAX launcher draws it from its
    key as ``jax.random.randint(key, (1,), 0, 2**31 - 1)``.  Same
    estimator as integrators.default_tracer.render_default
    (ref: default_path_tracing.cu:36-88).
    """
    device = torch.device(device)
    tris, mat = pack_scene(scene.to(device))
    n_slots = n_slots_for(cfg.n_pixels, r_tile, pix_mux)
    out = mega_default_frame(seed, camera_vector(camera), tris, mat, cfg,
                             n_slots, pix_mux)
    return assemble(*out, cfg)
