"""The binned main path of rlrpt_tpu_torch at the reference's own 12x12
sector grid on the CPU engine's test room, held to the benchmark's plain
reference (benchmark/reference/test_room.py, pathtrace.py) on the CPU:
the room's tables exactly, then on a seeded skewed Q and seeded visits
(the "random weights") at 32x32, 4 spp, 80 bounces: the CDF rebuild, a
learning frame (B2's twin) and a guided frame (B3's twin); and the
rebuild's zero-sector tally against a count on the reference's table.

The twins and the reference compute in float32 with the same counter
hash, the same exact Moller-Trumbore sweep and the same sector search, so
the images, path sums and visit counts are equal bit for bit; where a
tolerance is given it says why.  Each comparison is shown to fail for the
table read on an 11x11 grid, the grid the CLI maps 12 to by default."""

import numpy as np
import pytest
import torch

from benchmark.reference import pathtrace as pt
from benchmark.reference import test_room as ref_room
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.ops import guided_mega as gm
from rlrpt_tpu_torch.ops import guided_mega_train as gt
from rlrpt_tpu_torch.ops import megakernel as mk
from rlrpt_tpu_torch.scene.cornell import monte_carlo_test_scene
from rlrpt_tpu_torch.utils import profiling
from _torch_parity import one_torch_thread  # noqa: F401

G, UB = 12, 4
T_PAD = 24            # the test room: 18 triangles
RL = RadianceVolumeConfig(grid_resolution=G)
CFG = RenderConfig(width=32, height=32, samples_per_pixel=4,
                   max_ray_bounces=80)
FR = pt.Frame(32, 32, 4, 80)
CAM = Camera.create((0.0, 0.0, -3.0))
N_SLOTS = mk.n_slots_for(CFG.n_pixels, mk.R_TILE, mk.PIX_MUX)
# the learning cell's q_gap limit (benchmark/traffic/sarsa_mega_jobs_32spp
# .json): the largest |dQ| over the largest |Q| that the card's atomics,
# summing the TD targets in another order, stay far below
Q_GAP = 2e-3


@pytest.fixture(scope="module")
def room():
    """The port's scene, the reference's tables, and the seeded inputs."""
    q, _ = gt.init_bin_q(T_PAD, UB, G, RL.initial_radiance, device="cpu")
    rng = np.random.default_rng(12)
    q = q * torch.from_numpy(np.exp(3.0 * rng.random(q.shape)).astype(
        np.float32))
    v = torch.from_numpy(rng.integers(0, 3, q.shape).astype(np.float32))
    tables = ref_room.tables()
    return {"scene": monte_carlo_test_scene(device="cpu"), "tables": tables,
            "packed": tables.packed("cpu"), "q": q, "v": v,
            "cdf": gt.rebuild_bin_cdf(q, G, UB, T_PAD, jax_order=False)}


def test_reference_tables_are_the_ports_test_room(room):
    """Rebuilt from the engine's numbers, the reference's rows are the
    port's packed scene bit for bit: 16 surfaces, then the light's fan."""
    tris, mat = room["packed"]
    p_tris, p_mat = mk.pack_scene(room["scene"])
    assert room["tables"].n_triangles == room["scene"].n_triangles == 18
    assert torch.equal(tris, p_tris) and torch.equal(mat, p_mat)
    assert int(mat[:, 9].sum()) == 2 and float(mat[16:, 6:9].max()) == 5.0
    assert mk._t_pad(18) == T_PAD


@pytest.mark.parametrize("jax_order", [False, True],
                         ids=["torch_order", "jax_order"])
def test_rebuild_is_the_references(room, jax_order):
    """Summing with torch in the card's order, the bf16 table is the
    reference's bit for bit.  The CPU default sums in the JAX package's
    order, whose float32 rounding can land a CDF entry on the other side
    of a bf16 rounding step: an entry then moves by one bf16 unit (a
    relative 2^-7 at most), on a few entries (this Q: 0.1% or fewer)."""
    got = gt.rebuild_bin_cdf(room["q"], G, UB, T_PAD, jax_order=jax_order)
    ref = pt.rebuild_cdf(room["q"], G)
    assert (got.sector_grid, got.uv_bins, got.t_pad) == (G, UB, T_PAD)
    assert got.cdf.shape == ref.shape == (144, T_PAD * UB * UB)
    if jax_order:
        a, b = got.cdf.float(), ref.float()
        assert float(((a - b).abs() / b.abs()).max()) <= 2 ** -7
        assert float((a != b).double().mean()) <= 1e-3
    else:
        assert torch.equal(got.cdf, ref)
    wrong = gt.rebuild_bin_cdf(room["q"], 11, UB, T_PAD, jax_order=jax_order)
    assert wrong.cdf.shape == ref.shape and not torch.equal(wrong.cdf, ref)


def _learn(room, grid):
    return gt.mega_train_frame(
        5, mk.camera_vector(CAM), *mk.pack_scene(room["scene"]),
        room["cdf"].cdf.T.contiguous(),
        gt.bin_luminance(room["scene"], T_PAD, UB)[0],
        pt.sector_cos(grid, "cpu", torch.float32), room["q"], room["v"],
        grid, UB, RL.radiance_threshold, CFG, N_SLOTS, mk.PIX_MUX)


@pytest.fixture(scope="module")
def learned(room):
    """The reference's learning frame over the same table, Q and visits."""
    tris, mat = room["packed"]
    return pt.learn_frame(5, mk.camera_vector(CAM), tris, mat, FR, N_SLOTS,
                          mk.PIX_MUX, room["cdf"].cdf,
                          room["tables"].luminance_tensor("cpu"), room["q"],
                          room["v"], G, UB, RL.radiance_threshold)


def test_learning_frame_is_the_references(room, learned):
    """B2's twin through the launcher: the image, path sums and visits
    exactly; Q within the learning cell's q_gap limit (on the CPU both
    sides add each iteration's targets in one order, so it reads 0)."""
    img, q1, v1, aux = gt.render_sarsa_mega_train(
        5, room["scene"], CAM, room["cdf"], room["q"], room["v"], CFG,
        RL.radiance_threshold, "cpu")
    rad, path_sum, _, q_ref, v_ref, td = learned
    assert torch.equal(img.reshape(-1, 3), rad[0] / FR.spp)
    assert float(aux["avg_path_length"]) == float(
        path_sum.double().sum()) / (CFG.n_pixels * FR.spp)
    assert torch.equal(v1, v_ref)
    assert int(aux["td_scatter_count"]) == int(td) > 0
    gap = float((q1 - q_ref).abs().max() / q_ref.abs().max())
    assert gap <= Q_GAP
    assert float(v1[G * G:].sum()) == 0 and float(v1[:G * G].sum()) > 0


def test_learning_frame_on_the_wrong_grid_is_caught(room, learned):
    """The 12x12 table read as 11x11 (its first 121 rows): the sectors'
    directions and pdfs change, so the frame parts from the reference."""
    rad, _, _, _, v_ref, _ = learned
    out = _learn(room, 11)
    assert not torch.equal(out[0][0], rad[0])
    assert not torch.equal(out[4], v_ref)


@pytest.mark.parametrize("grid", [G, 11], ids=["g12", "wrong_grid_11"])
def test_guided_frame_is_the_references(room, grid):
    """B3's twin against the reference's guided frame over the same table:
    every pixel bit for bit at 12x12; read as 11x11 they differ."""
    tris, mat = room["packed"]
    rad, path_sum, _ = pt.render(7, mk.camera_vector(CAM), tris, mat, FR,
                                 N_SLOTS, mk.PIX_MUX,
                                 torch.arange(CFG.n_pixels),
                                 cdf=(G, UB, room["cdf"].cdf.T.contiguous()))
    if grid == G:
        img, aux = gm.render_guided_mega(7, room["scene"], CAM, room["cdf"],
                                         CFG, "cpu")
        img = img.reshape(-1, 3)
        assert float(aux["avg_path_length"]) == float(
            path_sum.double().sum()) / (CFG.n_pixels * FR.spp)
        assert torch.equal(img, rad[0] / FR.spp)
    else:
        out = gm.mega_guided_frame(7, mk.camera_vector(CAM),
                                   *mk.pack_scene(room["scene"]),
                                   room["cdf"].cdf.T.contiguous(), grid, UB,
                                   CFG, N_SLOTS, mk.PIX_MUX)
        assert not torch.equal(out[0][0], rad[0])


def _reference_zero_sectors(table: torch.Tensor) -> int:
    """Sectors of a reference table that its sampler draws with pdf 0,
    counted in numpy: hi - lo <= 0 with lo 0 before the first sector and
    hi 1 for the last (pathtrace.cdf_sampler)."""
    c = table[:G * G].float().numpy().astype(np.float64)
    hi = np.concatenate([c[:-1], np.ones_like(c[:1])])
    lo = np.concatenate([np.zeros_like(c[:1]), c[:-1]])
    return int((hi - lo <= 0.0).sum())


def test_zero_sector_tally_is_the_references_count(room):
    """While a profiler records, each rebuild adds its table's zero
    sectors and every sector it looked at to the recorder's device
    tallies; with none recording it tallies nothing."""
    rec = profiling.RECORDER
    rec.reset()
    tables = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        for q in (room["q"], gt.init_bin_q(T_PAD, UB, G, RL.initial_radiance,
                                           "cpu")[0]):
            gt.rebuild_bin_cdf(q, G, UB, T_PAD, jax_order=False)
            tables.append(pt.rebuild_cdf(q, G))
    counted = rec.tally_values()
    want = sum(_reference_zero_sectors(t) for t in tables)
    assert counted == {"rebuild_bin_cdf.zero_sectors": want,
                       "rebuild_bin_cdf.sectors": 2 * 144 * T_PAD * UB * UB}
    # the initial table's cos-weighted pdf leaves 10 of 144 sectors below
    # bf16's spacing in every column; the skewed Q more
    assert _reference_zero_sectors(tables[1]) == 10 * T_PAD * UB * UB
    assert want > 2 * 10 * T_PAD * UB * UB
    rec.reset()
    gt.rebuild_bin_cdf(room["q"], G, UB, T_PAD)
    assert rec.tally_values() == {}
