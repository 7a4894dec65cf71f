"""Plain neural-Q learning: the deep-Q path tracer's network, direction
sampler, TD targets, training and one wavefront iteration's transport,
one torch operation at a time, in the dtype ``ft`` the caller states
(float32 as the configurations state it, bfloat16 for the benchmark's
control).  Importing this module turns TF32 off for cuBLAS and cuDNN.

The reference engine's mode 3 (neural_q_pathtracer.cu,
nn_rendering_helpers.cu, NN_Builders/dq_network.cu, DyNet's Adam):

* the network: the relative-vertex encoding of a point (every vertex of
  the scene's 9T flat list minus the point, nn_rendering_helpers.cu:
  281-298), built explicitly here, then 9T -> 200 -> 300 -> 200 -> S
  affine layers, a ReLU after every one, the output's included
  (dq_network.cu:14-17);
* the sampler (nn_rendering_helpers.cu:300-489): with probability
  epsilon a uniform random sector ((u - 1e-4) S truncated, pdf RHO), else
  the inverse CDF of Q cos(theta) (pdf RHO p S); an all-zero row falls
  back to uniform; the direction is Chiu's concentric map of the sector's
  jittered grid point about the normal;
* the TD target: light r = luminance x 200, a miss 0, a surface
  luminance x max(Q_0, max_{a >= 1} Q_a cos_a), Q_0 entering the scan
  unweighted as the reference seeds it (nn_rendering_helpers.cu:91-140);
* training: the loss sum(w (td - Q(s, a))^2) of each ``batch`` rows in
  order, its gradients by a hand-written backward pass (ReLU's gradient 0
  where its input is not positive), one Adam step each (lr, b1, b2, eps;
  bias-corrected by 1 - b^t) (neural_q_pathtracer.cu:421-513).

Departures from the reference engine, each the port's too:

* the wavefront trains the slots' pending transitions, the rest of each
  minibatch weighted 0, and a minibatch with no live row takes no Adam
  step (the step count stays; DyNet would step on a zero gradient);
* epsilon is per lane (it decays per sample ordinal of the pixel), the
  bounce cap contributes tp x brdf with no direction factor, and a
  transition's update lands one iteration after the sampling at its new
  vertex (the port's regenerative wavefront).

``transport`` is what an iteration does with a hit once the sector is
drawn: the radiance gathered, the throughput carried and the finished
samples banked into their slot's row; ``assemble`` adds the banked rows
of every flush into the image.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import pathtrace as pt

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RHO = 1.0 / (2.0 * math.pi)
INF_CUT = 1.0e38     # a hit distance at or past this is a miss


def vertices_flat(tables) -> np.ndarray:
    """The scene's flat vertex list (v0 v1 v2 of each triangle, surfaces
    then lights): the network's input before the point is subtracted."""
    return np.concatenate([tables.v0, tables.v1, tables.v2],
                          axis=1).reshape(-1).astype(np.float32)


def encode(verts: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(R, 9T): every vertex minus the row's point."""
    return (verts.reshape(1, -1, 3) - pos[:, None, :]).reshape(
        pos.shape[0], verts.numel())


def layers_from_flat(flat: torch.Tensor, sizes) -> list:
    """[(w (out, in), b (out,))] of the network with layer widths
    ``sizes`` from a flat vector (each layer's weight, then its bias)."""
    out, i = [], 0
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        w = flat[i:i + n_in * n_out].reshape(n_out, n_in)
        i += n_in * n_out
        out.append((w, flat[i:i + n_out]))
        i += n_out
    return out


def n_params(sizes) -> int:
    return sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))


def forward(layers, x: torch.Tensor) -> list:
    """Every layer's output, the input first."""
    acts = [x]
    for w, b in layers:
        acts.append(torch.relu(acts[-1] @ w.T + b))
    return acts


def q_values(layers, verts, pos, ft=torch.float32) -> torch.Tensor:
    layers = [(w.to(ft), b.to(ft)) for w, b in layers]
    return forward(layers, encode(verts.to(ft), pos.to(ft)))[-1]


def sample(qs, u, normal, eps, grid: int, ft=torch.float32):
    """(sector (R,) int64, pdf (R,), direction (R, 3)) for the Q rows
    ``qs``, the uniforms ``u`` (R, 5) (explore draw, inverse-CDF draw,
    random-sector draw, jitter x 2) and ``eps`` (a number or (R,))."""
    s = grid * grid
    qs, u, normal = qs.to(ft), u.to(ft), normal.to(ft)
    w = qs * pt.sector_cos(grid, qs.device, ft)[None, :]
    total = w.sum(dim=-1, keepdim=True)
    dist = torch.where(total > 0.0, w / torch.where(total == 0.0, 1.0, total),
                       1.0 / s)
    cdf = torch.cumsum(dist, dim=-1)
    imp = torch.clamp((cdf <= u[:, 1:2]).sum(dim=-1), max=s - 1)
    pdf_imp = RHO * (dist.gather(1, imp[:, None])[:, 0] / (1.0 / s))
    rand = torch.clamp(((u[:, 2] - 1e-4) * s).to(torch.int32), 0,
                       s - 1).long()
    if isinstance(eps, torch.Tensor):
        eps = eps.to(ft)
    explore = u[:, 0] <= eps
    sector = torch.where(explore, rand, imp)
    pdf = torch.where(explore, torch.full_like(pdf_imp, RHO), pdf_imp)
    return sector, pdf, direction(sector, u[:, 3:5], normal, grid)


def direction(sector, jitter, normal, grid: int) -> torch.Tensor:
    """The sector's jittered grid point through Chiu's map about
    ``normal``."""
    sx = torch.div(sector, grid, rounding_mode="floor")
    sy = sector - sx * grid
    g = float(grid)
    dx, dy, dz, _ = pt.concentric_dir(
        (sx.to(jitter.dtype) + jitter[:, 0]) / g,
        (sy.to(jitter.dtype) + jitter[:, 1]) / g,
        normal[:, 0], normal[:, 1], normal[:, 2])
    return torch.stack([dx, dy, dz], dim=-1)


def hit_masks(active, t, tri, n_surfaces: int):
    """(missed, hit_light, hit_surface) of the live lanes."""
    missed = active & (t >= INF_CUT)
    light = active & ~missed & (tri >= n_surfaces)
    surface = active & ~missed & (tri < n_surfaces)
    return missed, light, surface


def td_targets(qs, lum, hit_light, hit_surface, reward_scale: float,
               grid: int, ft=torch.float32) -> torch.Tensor:
    qs, lum = qs.to(ft), lum.to(ft)
    cos = pt.sector_cos(grid, qs.device, ft)
    boot = torch.maximum(qs[:, 0], (qs[:, 1:] * cos[None, 1:]).max(-1).values)
    return torch.where(hit_light, lum * reward_scale,
                       torch.where(hit_surface, lum * boot,
                                   torch.zeros_like(lum)))


def gradients(layers, x, action, td, weight):
    """(the loss, [(dw, db)]) of one minibatch: sum(weight (td - Q_a)^2)
    and its gradients, backward by hand."""
    acts = forward(layers, x)
    rows = torch.arange(x.shape[0], device=x.device)
    err = td - acts[-1][rows, action]
    loss = (weight * err * err).sum()
    delta = torch.zeros_like(acts[-1])
    delta[rows, action] = -2.0 * weight * err
    grads = []
    for i in range(len(layers) - 1, -1, -1):
        delta = delta * (acts[i + 1] > 0).to(delta.dtype)
        grads.append((delta.T @ acts[i], delta.sum(dim=0)))
        if i:
            delta = delta @ layers[i][0]
    return loss, grads[::-1]


def adam(params, grads, mu, nu, count, lr, b1, b2, eps):
    """One Adam step; returns (params, mu, nu, count) anew.  The rates
    stay numbers and the bias corrections 1 - b^t are taken in float32,
    then rounded to the parameters' dtype (in bfloat16, b2 = 0.999 would
    round to 1 and 1 - b2^t to 0); every tensor keeps that dtype."""
    count = count + 1
    t = torch.as_tensor(float(count), dtype=torch.float32,
                        device=params[0].device)
    bc1 = (1.0 - torch.pow(b1, t)).to(params[0].dtype)
    bc2 = (1.0 - torch.pow(b2, t)).to(params[0].dtype)
    out = ([], [], [])
    for p, g, m, v in zip(params, grads, mu, nu):
        m = (1.0 - b1) * g + b1 * m
        v = (1.0 - b2) * (g * g) + b2 * v
        out[0].append(p - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)))
        out[1].append(m)
        out[2].append(v)
    return (*out, count)


def train(state: dict, sizes, verts, prev_loc, action, td, weights, *,
          batch: int, lr: float, b1: float, b2: float, eps: float,
          ft=torch.float32) -> dict:
    """The minibatches of one iteration, in order, from ``state`` (flat
    ``params``, ``mu``, ``nu`` as the program lays them out, and the
    step ``count``); returns the state after them, float32 and flat."""
    n = n_params(sizes)
    flat = state["flat"].to(ft)
    split = lambda v: [a for wb in layers_from_flat(v, sizes)  # noqa: E731
                       for a in wb]
    params, mu, nu = split(flat[:n]), split(flat[n:2 * n]), split(
        flat[2 * n:3 * n])
    count = int(state["count"])
    verts, prev_loc = verts.to(ft), prev_loc.to(ft)
    td, weights = td.to(ft), weights.to(ft)
    r = prev_loc.shape[0]
    b = min(batch, r)
    for s in range(0, r, b):
        w = weights[s:s + b]
        if not bool((w != 0).any()):
            continue            # no live row: no step
        layers = list(zip(params[0::2], params[1::2]))
        _, grads = gradients(layers, encode(verts, prev_loc[s:s + b]),
                             action[s:s + b], td[s:s + b], w)
        params, mu, nu, count = adam(params, [g for wb in grads for g in wb],
                                     mu, nu, count, lr, b1, b2, eps)
    cat = lambda xs: torch.cat([x.reshape(-1) for x in xs])  # noqa: E731
    return {"flat": torch.cat([cat(params), cat(mu), cat(nu)]).float(),
            "count": count}


def transport(state: dict, t, tri, mrow, sector, u, pdf, n_surfaces: int,
              env: float, max_bounces: int, grid: int, ft=torch.float32):
    """What an iteration makes of its hits once the sector is drawn, with
    no Russian roulette: (slot_rad (W, mux, 3), sample_rad (W, 3), tp
    (W, 3), survive (W,)), the sample radiance and throughput before a
    finished lane regenerates."""
    act = state["active"]
    missed, light, surface = hit_masks(act, t, tri, n_surfaces)
    mrow = mrow.to(ft)
    normal, diffuse, emission = mrow[:, 0:3], mrow[:, 3:6], mrow[:, 6:9]
    tp, srad = state["tp"].to(ft), state["sample_rad"].to(ft)
    contrib = (torch.where(missed[:, None], tp * env, 0.0)
               + torch.where(light[:, None], tp * emission, 0.0))
    new_d = direction(sector, u[:, 3:5].to(ft), normal, grid)
    cos = (normal * new_d).sum(dim=-1)
    brdf = diffuse / math.pi
    exhausted = surface & (state["bounce"] + 1 >= max_bounces)
    survive = surface & ~exhausted
    srad = srad + contrib + torch.where(exhausted[:, None], tp * brdf, 0.0)
    tp = torch.where(survive[:, None],
                     tp * brdf * (cos / torch.clamp(pdf.to(ft), min=1e-12))
                     [:, None], tp)
    finished = act & ~survive
    slot = state["slot_rad"].to(ft).clone()
    banked = torch.where(finished[:, None], srad, 0.0)
    for k in range(slot.shape[1]):
        row = state["kmx"] == k
        slot[:, k] = slot[:, k] + torch.where(row[:, None], banked, 0.0)
    return slot, srad, tp, survive


def assemble(flushes, n_pix: int, w0: int, spp: int,
             ft=torch.float32) -> torch.Tensor:
    """(n_pix, 3): every flush's banked rows (pixel, kmx, slot_rad) added
    at their pixels (a slot's k-th row holds pixel slot + k w0), over
    ``spp``."""
    image = None
    for pixel, kmx, slot_rad in flushes:
        if image is None:
            image = torch.zeros((n_pix, 3), dtype=ft, device=pixel.device)
        s0 = pixel - kmx * w0
        for k in range(slot_rad.shape[1]):
            idx = s0 + k * w0
            ok = (idx >= 0) & (idx < n_pix)
            image[idx[ok]] += slot_rad[ok, k].to(ft)
    return image / spp
