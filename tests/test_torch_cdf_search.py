"""The guided kernels' sector search (csrc/path_common.cuh:CdfSampler) on
the CPU.

The kernels draw sector = #{entries < u}, clipped to S-1, as the torch
twin and the JAX kernel count it, but find it by a binary search, which
equals the count only on a non-decreasing column.  These tests hold that:
every table the port builds (``rebuild_bin_cdf``, also at skews that make
zero-probability ties, and ``bake_tri_bin_cdf``) is non-decreasing per
column, as JAX's rebuild of the same Q is; on those bf16 columns the
search (``torch.searchsorted`` and a vectorised copy of the kernel's loop)
equals the count, with u on an entry, in flat runs and between entries;
and ``check_cdf`` refuses a column that decreases.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlrpt_tpu.ops import guided_mega_train as jgt
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.ops import guided_mega as gm
from rlrpt_tpu_torch.ops import guided_mega_train as gt
from rlrpt_tpu_torch.ops import megakernel as mk
from rlrpt_tpu_torch.radiance import bake
from rlrpt_tpu_torch.radiance import volumes as tv
from rlrpt_tpu_torch.scene import cornell_box

T_PAD = 40            # cornell: 38 triangles
SKEWS = [0.0, 3.0, 12.0, 30.0]


def _q(sector_grid: int, uv_bins: int, skew: float, seed: int = 0):
    """Initial binned Q skewed per entry by exp(skew * U[0, 1))."""
    q, _ = gt.init_bin_q(T_PAD, uv_bins, sector_grid,
                         100.0 / sector_grid ** 2, device="cpu")
    u = np.random.default_rng(seed).random(q.shape)
    return (q.numpy() * np.exp(skew * u)).astype(np.float32)


def _rebuilt(sector_grid: int, skew: float):
    return gt.rebuild_bin_cdf(torch.from_numpy(_q(sector_grid, 4, skew)),
                              sector_grid, 4, T_PAD)


@pytest.fixture(scope="module")
def baked():
    """Bakes of a skewed fine map (area 0.05, Q = U^4 + 1e-3 from numpy
    seed 3) at (sector_grid, uv_bins) (11, 4) and (12, 2)."""
    rl = RadianceVolumeConfig(area_per_sample=0.05)
    scene = cornell_box(device="cpu")
    vols = tv.build_radiance_volumes(scene, rl)
    u = np.random.default_rng(3).random(tuple(vols.q.shape))
    vols = tv.rebuild_cdf(dataclasses.replace(
        vols, q=torch.from_numpy((u ** 4 + 1e-3).astype(np.float32))))
    return {(sg, ub): bake.bake_tri_bin_cdf(scene, vols, rl, T_PAD,
                                            uv_bins=ub, sector_grid=sg)
            for sg, ub in ((11, 4), (12, 2))}


def _columns(table) -> torch.Tensor:
    """(C, S_pad) f32 columns of a bf16 TriBinCDF (exact)."""
    assert table.cdf.dtype == torch.bfloat16
    return table.cdf.T.float().contiguous()


def _non_decreasing(cols: torch.Tensor) -> bool:
    return bool((cols[:, 1:] >= cols[:, :-1]).all())


def _ties(cols: torch.Tensor, n_sectors: int) -> int:
    """Zero-probability sectors: equal neighbours among the real rows."""
    real = cols[:, :n_sectors]
    return int((real[:, 1:] == real[:, :-1]).sum())


@pytest.mark.parametrize("sector_grid", [11, 12])
@pytest.mark.parametrize("skew", SKEWS)
def test_rebuild_bin_cdf_non_decreasing(sector_grid, skew):
    """Every column of the bf16 rebuild is non-decreasing, padding rows of
    2.0 included, as JAX's rebuild of the same Q is; strong skews do make
    zero-probability ties."""
    q = _q(sector_grid, 4, skew)
    cols = _columns(gt.rebuild_bin_cdf(torch.from_numpy(q), sector_grid, 4,
                                       T_PAD))
    assert _non_decreasing(cols)
    assert bool((cols[:, sector_grid ** 2:] == 2.0).all())
    j = np.asarray(jgt.rebuild_bin_cdf(jnp.asarray(q), sector_grid, 4,
                                       T_PAD).cdf, np.float32).T
    assert (np.diff(j, axis=1) >= 0).all()
    if skew >= 12.0:
        assert _ties(cols, sector_grid ** 2) > 0


@pytest.mark.parametrize("grid_bins", [(11, 4), (12, 2)],
                         ids=["g11_uv4", "g12_uv2"])
def test_bake_non_decreasing(baked, grid_bins):
    table = baked[grid_bins]
    cols = _columns(table)
    assert cols.shape == (T_PAD * grid_bins[1] ** 2,
                          table.cdf.shape[0])
    assert _non_decreasing(cols)
    assert _ties(cols, table.n_sectors) > 0


def _draws(cols: torch.Tensor, seed: int) -> torch.Tensor:
    """(C, K) f32 draws per column: uniforms, every entry below 1 exactly,
    and the f32 neighbours of each entry, all in [0, 1)."""
    c, s_pad = cols.shape
    u = torch.from_numpy(np.random.default_rng(seed).random(
        (c, 64)).astype(np.float32))
    below = torch.nextafter(cols, torch.zeros_like(cols))
    above = torch.nextafter(cols, torch.ones_like(cols))
    d = torch.cat([u, cols, below, above], dim=1)
    return torch.where((d >= 0.0) & (d < 1.0), d, u[:, :1])


def _count(cols: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """The twin's count (ops/guided_mega.py:_cdf_sampler), unclipped."""
    return (cols[:, None, :] < us[:, :, None]).sum(dim=2)


def _kernel_search(cols: torch.Tensor, us: torch.Tensor,
                   n_sectors: int) -> torch.Tensor:
    """csrc/path_common.cuh:CdfSampler's loop, vectorised: the lower
    bound of us among entries [0, S-1)."""
    lo = torch.zeros(us.shape, dtype=torch.int64)
    n = torch.full(us.shape, n_sectors - 1, dtype=torch.int64)
    row = torch.arange(cols.shape[0])[:, None].expand(us.shape)
    while bool((n > 0).any()):
        half = n >> 1
        probe = torch.clamp(lo + half, max=cols.shape[1] - 1)
        go_right = (n > 0) & (cols[row, probe] < us)
        lo = torch.where(go_right, lo + half + 1, lo)
        n = torch.where(go_right, n - half - 1, torch.where(n > 0, half, n))
    return lo


def _assert_search_equals_count(cols, n_sectors, seed):
    us = _draws(cols, seed)
    cnt = _count(cols, us)
    found = torch.searchsorted(cols, us, right=False)
    assert torch.equal(found, cnt)
    clipped = torch.clamp(cnt, max=n_sectors - 1)
    assert torch.equal(_kernel_search(cols, us, n_sectors), clipped)
    # the cases that make a search differ from a count did occur
    assert bool((us == cols.gather(1, torch.clamp(cnt, max=cols.shape[1]
                                                  - 1))).any())


@pytest.mark.parametrize("sector_grid", [11, 12])
@pytest.mark.parametrize("skew", SKEWS)
def test_search_equals_count_rebuilt(sector_grid, skew):
    cols = _columns(_rebuilt(sector_grid, skew))
    _assert_search_equals_count(cols, sector_grid ** 2, seed=int(skew))


@pytest.mark.parametrize("grid_bins", [(11, 4), (12, 2)],
                         ids=["g11_uv4", "g12_uv2"])
def test_search_equals_count_baked(baked, grid_bins):
    table = baked[grid_bins]
    _assert_search_equals_count(_columns(table), table.n_sectors, seed=5)


def test_search_differs_from_count_when_decreasing():
    """Why the tables are checked: on a decreasing column the search and
    the count part."""
    cols = torch.tensor([[0.5, 0.2, 0.9, 1.0]])
    us = torch.tensor([[0.3]])
    assert int(_count(cols, us)) == 1
    assert int(_kernel_search(cols, us, 4)) == 2


@pytest.mark.parametrize("where", ["first_column", "middle", "padding"])
def test_check_cdf_rejects_decreasing_column(where):
    """check_cdf, and through it the guided wrappers, raise ValueError on
    a column that decreases anywhere, on the CPU; the same table
    unbroken passes."""
    table = _rebuilt(11, 3.0)
    cdf_t = table.cdf.T.contiguous()
    tris, mat = mk.pack_scene(cornell_box(device="cpu"))
    gm.check_cdf(cdf_t, tris, 11, 4)
    col, row = {"first_column": (0, 5), "middle": (37, 60),
                "padding": (100, 122)}[where]
    bad = cdf_t.clone()
    bad[col, row] = bad[col, row - 1] - 0.25
    with pytest.raises(ValueError, match="decrease"):
        gm.check_cdf(bad, tris, 11, 4)
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                       max_ray_bounces=2)
    cam = mk.camera_vector(Camera.create((0.0, 0.0, -3.0)))
    with pytest.raises(ValueError, match="decrease"):
        gm.mega_guided_frame(1, cam, tris, mat, bad, 11, 4, cfg, 64, 1)
