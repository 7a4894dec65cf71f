"""rlrpt_tpu_torch.parallel.multihost: two processes form a gloo group
through ``initialize`` (tests/_torch_dist_worker.py), render a sharded
default frame and assemble each rank's rows back; the assembled image is
the same on both ranks and equal, bit for bit, to the world-1 computation
of each rank's share on the same per-rank seeds.  ``host_local_slice``
follows the JAX function's formula, and ``spawn`` fails rather than hangs.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rlrpt_tpu.parallel import multihost as jmh
from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RenderConfig
from rlrpt_tpu_torch.parallel import dp, multihost
from rlrpt_tpu_torch.parallel.mesh import Mesh, make_mesh
from rlrpt_tpu_torch.scene import cornell_box
from _torch_dist_worker import run

CFG = RenderConfig(width=16, height=16, samples_per_pixel=2,
                   max_ray_bounces=4, ray_tile=256)


def test_two_process_render_assembles_the_world_1_image():
    outs = multihost.spawn(run, 2, ("assemble", {"seed": 0, "cfg": CFG}),
                           timeout=120)
    for o in outs:
        assert o["assembled"].shape == (16, 16, 3)
        assert np.array_equal(o["assembled"], outs[0]["assembled"])
        assert np.array_equal(o["assembled"], o["img"])
    assert [o["rows"] for o in outs] == [(0, 8), (8, 16)]
    # each rank's share computed in one process, on the same seeds
    parts = [dp._default_shard(0, r, 2, cornell_box(device="cpu"),
                               Camera.create([0.0, 0.0, -3.0]), CFG, "cpu")
             for r in range(2)]
    acc = torch.cat([p[0] for p in parts])[:CFG.n_pixels]
    ref = (acc / CFG.samples_per_pixel).reshape(16, 16, 3).numpy()
    assert np.array_equal(outs[0]["assembled"], ref)


def _jax_slice(n, p, count):
    """rlrpt_tpu.parallel.multihost.host_local_slice for process p of
    count."""
    per = n // count
    return slice(p * per, (p + 1) * per if p < count - 1 else n)


@pytest.mark.parametrize("n", [16, 7, 1])
def test_host_local_slice_is_jaxs_formula(n):
    assert multihost.host_local_slice(n) == jmh.host_local_slice(n)
    for count in (2, 3, 4):
        for p in range(count):
            mesh = Mesh(None, p, count, torch.device("cpu"))
            assert multihost.host_local_slice(n, mesh) == _jax_slice(
                n, p, count)


def test_initialize_without_a_cluster_is_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.initialize(device="cpu")
    assert not dist.is_initialized()
    assert make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize("127.0.0.1:1", device="cpu")


def test_spawn_fails_rather_than_hangs():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        multihost.spawn(run, 2, ("fail_on_rank_1", {}), timeout=60)
    # rank 0 may be late too on a busy host; rank 1 must be
    with pytest.raises(RuntimeError, match=r"ranks \[(0, )?1\] not done"):
        multihost.spawn(run, 2, ("hang_on_rank_1", {}), timeout=10)
