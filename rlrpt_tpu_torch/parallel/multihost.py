"""Process-group set-up, image assembly and rank spawning (counterpart of
``rlrpt_tpu/parallel/multihost.py``).

A multi-process run is the same program as a single-process one:
``initialize`` first, then ``parallel.mesh.make_mesh`` sees the group and
the ``parallel.dp`` renderers run unchanged.  The backend follows the
device: NCCL for the card, gloo for the CPU.  ``spawn`` starts the ranks
of one host from Python (the tools' own launcher; ``torchrun`` does the
same from the shell).
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from rlrpt_tpu_torch.parallel.mesh import Mesh, all_gather, make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda") -> None:
    """Form the process group: NCCL when ``device`` is the card, gloo for
    the CPU.  ``coordinator_address`` ("host:port" or a URL): the group of
    ``num_processes`` ranks meets there (a group of one too, so a
    one-card run goes through the same backend).  With no address, the
    torchrun environment (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT)
    when it names more than one process; otherwise this is one process
    and nothing is formed.  A no-op when a group is already up.  A failed
    initialisation raises (the JAX package swallows auto-detection
    errors; this does not)."""
    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError("num_processes and process_id need a "
                             "coordinator_address")
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return
        dist.init_process_group(backend, init_method="env://")
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator_address needs num_processes and "
                         "process_id")
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))


def _mesh_of(mesh: Mesh | None, device) -> Mesh:
    return mesh if mesh is not None else make_mesh(device=device)


def assemble_image(img: torch.Tensor, mesh: Mesh | None = None):
    """Every rank's row shard of an image (one shape on all ranks)
    concatenated in rank order, on every rank; one process gets its image
    back."""
    return all_gather(img, _mesh_of(mesh, img.device))


def host_local_slice(n: int, mesh: Mesh | None = None) -> slice:
    """The [start, stop) range of a length-n global axis this rank owns
    under equal sharding (the last rank takes the remainder)."""
    m = _mesh_of(mesh, "cpu")
    per = n // m.size
    return slice(m.rank * per, (m.rank + 1) * per if m.rank < m.size - 1
                 else n)


def free_port() -> int:
    """A TCP port on the loopback interface that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(results, fn, rank: int, n: int, address: str, args) -> None:
    try:
        results.put((rank, True, fn(rank, n, address, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, n_processes: int, args=(), timeout: float = 600.0) -> list:
    """Run ``fn(rank, n_processes, address, *args)`` in ``n_processes``
    spawned processes, ``address`` a free loopback "host:port" for
    ``initialize``; returns their return values (which must pickle) in
    rank order.  ``fn`` must be importable from a module (spawn re-imports
    it in each child).  A rank that raises, dies or is not done within
    ``timeout`` seconds fails the call: every rank still running is
    killed, and RuntimeError names the rank and carries its traceback."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    address = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(results, fn, r, n_processes, address, args),
                         daemon=True) for r in range(n_processes)]
    deadline = time.monotonic() + timeout
    out: dict = {}
    try:
        for p in procs:
            p.start()
        while len(out) < n_processes:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(n_processes)) - set(out))
                raise RuntimeError(f"ranks {late} not done within "
                                   f"{timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead and results.empty():
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10.0)
        results.close()
    return [out[r] for r in range(n_processes)]
