"""State carried across from the JAX package as numpy arrays.

The parity tests build both sides through these: the JAX objects are
turned into numpy (``np.asarray``) and handed over here, so this package
never imports the JAX one.
"""

from __future__ import annotations

import numpy as np
import torch

from rlrpt_tpu_torch.nn.adam import AdamState
from rlrpt_tpu_torch.nn.dq_network import DQNetwork
from rlrpt_tpu_torch.radiance.bake import TriBinCDF
from rlrpt_tpu_torch.radiance.grid_bucket import VolumeClassTable, VolumeGrid
from rlrpt_tpu_torch.radiance.volumes import RadianceVolumes
from rlrpt_tpu_torch.scene.scene import Scene


def scene_from_numpy(v0, v1, v2, normal, diffuse_c, emission, luminance,
                     n_surfaces: int, device="cpu") -> Scene:
    """A Scene from the JAX Scene's arrays (surfaces first, then lights)."""
    t = lambda a: torch.as_tensor(  # noqa: E731
        np.array(a, np.float32), device=device)
    return Scene(v0=t(v0), v1=t(v1), v2=t(v2), normal=t(normal),
                 diffuse_c=t(diffuse_c), emission=t(emission),
                 luminance=t(luminance), n_surfaces=int(n_surfaces))


def tri_bin_cdf_from_numpy(cdf, sector_grid: int, uv_bins: int, t_pad: int,
                           device="cpu") -> TriBinCDF:
    """A TriBinCDF from a JAX table's (S_pad, C) cdf.  The values are
    rounded to bf16 as the JAX kernel rounds them; a bf16 table converts
    exactly."""
    cdf = torch.as_tensor(np.array(cdf, np.float32), device=device)
    return TriBinCDF(cdf=cdf.to(torch.bfloat16), sector_grid=sector_grid,
                     uv_bins=uv_bins, t_pad=t_pad)


def bin_q_from_numpy(q, visits, device="cpu"):
    """The binned trainer's (q, visits), (S_pad, C) float32 each."""
    return (torch.as_tensor(np.array(q, np.float32), device=device),
            torch.as_tensor(np.array(visits, np.float32), device=device))


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a, dtype), device=device)


def volumes_from_numpy(position, normal, frame, surface_lum, q, visits, cdf,
                       grid_resolution: int, device="cpu") -> RadianceVolumes:
    """RadianceVolumes from the JAX pytree's arrays."""
    f = lambda a: _t(a, np.float32, device)  # noqa: E731
    return RadianceVolumes(
        position=f(position), normal=f(normal), frame=f(frame),
        surface_lum=f(surface_lum), q=f(q),
        visits=_t(visits, np.int32, device), cdf=f(cdf),
        grid_resolution=int(grid_resolution))


def volume_grid_from_numpy(payload, origin, inv_cell, dims, k_max: int,
                           device="cpu") -> VolumeGrid:
    """A VolumeGrid from the JAX grid's arrays and static fields."""
    return VolumeGrid(payload=_t(payload, np.float32, device),
                      origin=_t(origin, np.float32, device),
                      inv_cell=_t(inv_cell, np.float32, device),
                      dims=tuple(int(n) for n in dims), k_max=int(k_max))


def dq_network_from_numpy(layers, device="cpu") -> DQNetwork:
    """A DQNetwork from the JAX DQNetworkParams' layers, as a list of
    (w (out, in), b (out,)) arrays."""
    return DQNetwork.from_layers(
        [(np.array(w, np.float32), np.array(b, np.float32))
         for w, b in layers], device=device)


def dq_network_to_numpy(net: DQNetwork) -> list:
    """The network's layers as (w (out, in), b (out,)) float32 arrays."""
    return [(layer.weight.detach().cpu().numpy(),
             layer.bias.detach().cpu().numpy()) for layer in net.layers]


def adam_state_from_numpy(count, mu, nu, device="cpu") -> AdamState:
    """An AdamState from optax's ScaleByAdamState: the step count and the
    first and second moments, flattened in the network's parameter order
    (w1, b1, w2, b2, ...)."""
    f = lambda a: _t(a, np.float32, device)  # noqa: E731
    return AdamState(count=torch.tensor(int(count), dtype=torch.int32,
                                        device=device),
                     mu=tuple(f(a) for a in mu), nu=tuple(f(a) for a in nu))


def volume_class_table_from_numpy(table, tri_class, origin, inv_cell, dims,
                                  n_slots: int,
                                  device="cpu") -> VolumeClassTable:
    """A VolumeClassTable from the JAX table's arrays and static fields."""
    return VolumeClassTable(table=_t(table, np.int32, device),
                            tri_class=_t(tri_class, np.int32, device),
                            origin=_t(origin, np.float32, device),
                            inv_cell=_t(inv_cell, np.float32, device),
                            dims=tuple(int(n) for n in dims),
                            n_slots=int(n_slots))
