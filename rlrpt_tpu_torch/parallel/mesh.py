"""Process groups for the data-parallel layer (counterpart of
``rlrpt_tpu/parallel/mesh.py``).

The JAX package runs one program over a device mesh inside one process
(``shard_map``); here every rank is a process of a ``torch.distributed``
group, and a ``Mesh`` is one process's view of that group: the group, its
rank, the world size and the device its tensors live on.  What carries
over exactly is the math of the reductions: a JAX ``psum`` is an
``all_reduce(SUM)`` (``psum`` below), a ``pmean`` a sum divided by the
world size, and ``process_allgather(tiled=True)`` an ``all_gather`` in
rank order (``all_gather`` below).  Every collective of the port goes
through these two.

The backend follows the device of the tensors: NCCL serves CUDA tensors
and gloo CPU tensors (gloo also takes CUDA tensors, through the host,
which is how two ranks share one card).  An NCCL group handed CPU tensors
raises ``ValueError``; nothing switches backend or device behind the
caller's back.  With no process group initialised, ``make_mesh`` gives a
world of one that issues no collectives, as JAX's one-device mesh does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from rlrpt_tpu_torch.utils.rng import fold_in


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a group of ranks."""

    group: object | None     # a ProcessGroup; None: a world of one
    rank: int
    size: int
    device: torch.device     # where this rank's tensors live

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)


def make_mesh(group=None, device="cuda") -> Mesh:
    """The mesh of ``group`` (default: the initialised world), with its
    tensors on ``device`` (the card unless the caller asks for the CPU).
    A world of one when no process group is initialised."""
    device = torch.device(device)
    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise ValueError("a group was given, but torch.distributed is "
                             "not initialised")
        return Mesh(None, 0, 1, device)
    if group is None:
        group = dist.group.WORLD
    if dist.get_backend(group) == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL group serves CUDA tensors, not {device}; "
                         "initialise a gloo group for the CPU")
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                device)


def ray_specs(n: int, mesh: Mesh):
    """(sharded-over-rays, replicated) index specs of an ``n``-ray axis
    padded to a multiple of the world size: this rank's slice, and the
    whole axis."""
    lo, n_local = shard_range(n, mesh)
    return slice(lo, lo + n_local), slice(None)


def pad_to_multiple(n: int, m: int) -> int:
    """Rays are padded so every rank gets an equal shard."""
    return n + ((-n) % m)


def shard_range(n: int, mesh: Mesh) -> tuple:
    """(first index, length) of this rank's shard of ``n`` items, the
    length ceil(n / world) on every rank (the last shard may run past
    ``n``)."""
    n_local = -(-n // mesh.size)
    return mesh.rank * n_local, n_local


def rank_seed(seed: int, rank: int) -> int:
    """The int seed of ``rank``'s stream, the counterpart of JAX's
    ``fold_in(key, axis_index)``."""
    return fold_in(int(seed), int(rank))


def seed_of_rank(seed, mesh: Mesh) -> int:
    """This rank's int seed from an int ``seed`` (``rank_seed``) or from a
    sequence of per-rank seeds, one a rank."""
    if isinstance(seed, int):
        return rank_seed(seed, mesh.rank)
    seeds = [int(s) for s in seed]
    if len(seeds) != mesh.size:
        raise ValueError(f"{len(seeds)} seeds for a world of {mesh.size}")
    return seeds[mesh.rank]


def _check(tensor: torch.Tensor, mesh: Mesh) -> None:
    if tensor.device.type != mesh.device.type:
        raise ValueError(f"a {tensor.device} tensor on a mesh of "
                         f"{mesh.device} tensors")
    if mesh.backend == "nccl" and tensor.device.type != "cuda":
        raise ValueError(f"an NCCL group serves CUDA tensors, not "
                         f"{tensor.device}")


def psum(tensor: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum of ``tensor`` over the mesh's ranks (JAX's psum), in
    place: ``tensor`` must be contiguous, and is returned.  A world of one
    (or ``mesh`` None) returns it untouched."""
    if mesh is None or mesh.group is None:
        return tensor
    _check(tensor, mesh)
    if not tensor.is_contiguous():
        raise ValueError("psum sums in place: pass a contiguous tensor")
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=mesh.group)
    return tensor


def all_gather(tensor: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Every rank's ``tensor`` (one shape on all ranks) concatenated along
    dim 0 in rank order (JAX's process_allgather(tiled=True)); a world of
    one returns it untouched."""
    if mesh is None or mesh.group is None:
        return tensor
    _check(tensor, mesh)
    tensor = tensor.contiguous()
    parts = [torch.empty_like(tensor) for _ in range(mesh.size)]
    dist.all_gather(parts, tensor, group=mesh.group)
    return torch.cat(parts)


def any_rank(flag: torch.Tensor, mesh: Mesh | None) -> bool:
    """A () bool tensor OR'd over the ranks, read on the host (one psum of
    an int): a loop that issues collectives takes its exit on this, so
    every rank runs the same number of trips."""
    if mesh is None or mesh.group is None:
        return bool(flag)
    return bool(psum(flag.to(torch.int32).reshape(1), mesh) > 0)
