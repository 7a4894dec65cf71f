"""Radiance-map persistence (counterpart of ``rlrpt_tpu/radiance/map_io.py``;
the text it writes is byte-equal to the JAX writer's).

* radiance_map_data.txt: the action count, then one `x y z q1..qS` row per
  volume (ref: radiance_map.cu:237-268; read back by NN_Q_Value_Trainer/
  Source/main.cu:73-116);
* selected volumes: `x y z nx ny nz p1..pS` rows of the plain sampling
  distribution at probe points (ref: radiance_volume.cu:340-365,
  radiance_map.cu:272-302), probes read from to_select.txt (ref:
  hemisphere_helpers.cu:230-281), and their reload (ref:
  radiance_volume.cu:377-437);
* an npz checkpoint of the whole tabular state.
"""

from __future__ import annotations

import numpy as np
import torch

from rlrpt_tpu_torch.ops.linalg import make_frame
from rlrpt_tpu_torch.radiance.nn_search import find_closest_volume
from rlrpt_tpu_torch.radiance.volumes import RadianceVolumes


def _fmt(x: float) -> str:
    return f"{float(x):.6g}"


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def cdf_to_distribution(cdf: np.ndarray) -> np.ndarray:
    """Cumulative -> plain distribution (ref: radiance_volume.cu:331-336)."""
    out = np.asarray(cdf, np.float32).copy()
    out[..., 1:] = out[..., 1:] - out[..., :-1]
    return out


def save_q_vals_to_file(vols: RadianceVolumes, path: str) -> None:
    pos, q = _np(vols.position), _np(vols.q)
    with open(path, "w") as f:
        f.write(f"{q.shape[1]}\n")
        for i in range(len(pos)):
            row = " ".join(_fmt(x) for x in pos[i])
            row += " " + " ".join(_fmt(x) for x in q[i])
            f.write(row + "\n")


def load_radiance_map_data(path: str) -> tuple[np.ndarray, np.ndarray, int]:
    """Read radiance_map_data.txt -> (positions (V, 3), q (V, S),
    action_count)."""
    with open(path) as f:
        action_count = int(f.readline().strip())
        pos, q = [], []
        for line in f:
            vals = [float(t) for t in line.split()]
            if not vals:
                continue
            pos.append(vals[:3])
            q.append(vals[3: 3 + action_count])
    return (np.asarray(pos, np.float32), np.asarray(q, np.float32),
            action_count)


def read_probe_points(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read to_select.txt probe `x y z nx ny nz` lines."""
    locs, norms = [], []
    with open(path) as f:
        for line in f:
            vals = [float(t) for t in line.split()]
            if len(vals) >= 6:
                locs.append(vals[:3])
                norms.append(vals[3:6])
    return np.asarray(locs, np.float32), np.asarray(norms, np.float32)


def save_selected_volumes(vols: RadianceVolumes, probe_path: str,
                          out_path: str) -> None:
    """Dump the sampling distribution of the volume nearest each probe
    point (ref: radiance_map.cu:272-302 -> selected_sarsa.txt)."""
    locs, norms = read_probe_points(probe_path)
    dev = vols.device
    idx = _np(find_closest_volume(vols, torch.as_tensor(locs, device=dev),
                                  torch.as_tensor(norms, device=dev)))
    dist = cdf_to_distribution(_np(vols.cdf))
    pos, nrm = _np(vols.position), _np(vols.normal)
    with open(out_path, "w") as f:
        for i in idx:
            row = list(pos[i]) + list(nrm[i]) + list(dist[i])
            f.write(" ".join(_fmt(x) for x in row) + "\n")


def load_volumes_from_selected(path: str, grid_resolution: int = 12,
                               device="cuda") -> RadianceVolumes:
    """Rebuild RadianceVolumes from selected-volume rows: q is the stored
    plain distribution and the CDF its cumulative sum."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = [float(t) for t in line.split()]
            if vals:
                rows.append(vals)
    arr = torch.as_tensor(np.asarray(rows, np.float32), device=device)
    s = grid_resolution * grid_resolution
    pos, nrm, dist = arr[:, :3], arr[:, 3:6], arr[:, 6:6 + s]
    v = arr.shape[0]
    return RadianceVolumes(
        position=pos.contiguous(), normal=nrm.contiguous(),
        frame=make_frame(nrm),
        surface_lum=torch.ones((v,), dtype=torch.float32, device=device),
        q=dist.contiguous(),
        visits=torch.zeros((v, s), dtype=torch.int32, device=device),
        cdf=torch.cumsum(dist, dim=-1), grid_resolution=grid_resolution)


def save_volumes_npz(vols: RadianceVolumes, path: str) -> None:
    """Binary checkpoint of the whole tabular state (the JAX package's
    npz layout, so either package reads the other's)."""
    np.savez_compressed(
        path, position=_np(vols.position), normal=_np(vols.normal),
        frame=_np(vols.frame), surface_lum=_np(vols.surface_lum),
        q=_np(vols.q), visits=_np(vols.visits), cdf=_np(vols.cdf),
        grid_resolution=vols.grid_resolution)


def load_volumes_npz(path: str, device="cuda") -> RadianceVolumes:
    with np.load(path) as z:
        t = {k: torch.as_tensor(z[k], device=device)
             for k in ("position", "normal", "frame", "surface_lum", "q",
                       "visits", "cdf")}
        return RadianceVolumes(**t, grid_resolution=int(z["grid_resolution"]))
