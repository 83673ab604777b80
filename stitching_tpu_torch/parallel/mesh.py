"""The process group and the collectives of multi-GPU stitching.

Port of `stitching_tpu/parallel/mesh.py` on `torch.distributed`: one
process per GPU, SPMD. Every process calls `stitch` with the same inputs;
the image, match-pair, bundle-edge and tile axes are split into one
contiguous block per rank, and the ranks merge their shares with the
collectives below (NCCL on the card, gloo on the CPU).

Multi-GPU usage, one process per GPU under a launcher
(`torchrun --nproc_per_node=N script.py`):

    from stitching_tpu_torch import Stitcher
    from stitching_tpu_torch.parallel import mesh as pmesh
    pmesh.init_distributed()          # torch's env:// rendezvous
    m = pmesh.make_mesh()             # every rank, NCCL, cuda:LOCAL_RANK
    pano = Stitcher(mesh=m).stitch(images)   # the same images on every rank

Every rank returns the same panorama. In a single process `make_mesh`
makes a world of one in process, so the same code runs on one card.

A gloo group may hold tensors on the card: the helpers copy them through
host memory for the collective and back (how two ranks share one card).
A CPU tensor in an NCCL group raises; nothing switches the backend.
"""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..errors import StitchingError


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D group of ranks: the process group, its size D, this process's
    rank in it, the device this rank computes on and the backend."""

    group: object
    size: int
    rank: int
    device: torch.device
    backend: str

    def block(self, n):
        """[lo, hi) of this rank's contiguous block of a leading axis of
        length n (a multiple of the size)."""
        if n % self.size:
            raise StitchingError(f"an axis of {n} does not divide over "
                                 f"{self.size} ranks")
        b = n // self.size
        return self.rank * b, (self.rank + 1) * b


def init_distributed(backend=None, init_method=None, world_size=None,
                     rank=None, device="cuda"):
    """Join the launcher's process group (idempotent).

    Without arguments this is torch's `env://` rendezvous on the
    variables a launcher such as `torchrun` sets (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK); in a single process without them it
    does nothing and returns False, as one card needs no group. The
    backend is NCCL for `device` "cuda" and gloo for "cpu" unless given.
    Returns True when this call made the group."""
    if dist.is_initialized():
        return False
    if world_size is None and init_method is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
        if world_size == 1:
            return False
    dev = torch.device(device)
    backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
    if backend == "nccl":
        torch.cuda.set_device(_local_cuda(dev))
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank))
    return True


def _local_cuda(dev):
    """The card of this process: an explicit index, else the launcher's
    LOCAL_RANK, else the rank modulo the cards of the host."""
    if dev.index is not None:
        return dev
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(n_devices=None, device="cuda"):
    """A `Mesh` over the first `n_devices` ranks (every rank by default).

    Without a process group this makes a world of one in process (a
    `HashStore`): NCCL for `device` "cuda", gloo for "cpu". Under an
    existing group the backend is the group's. `device` "cuda" means
    cuda:LOCAL_RANK; "cuda:k" names the card. Every rank of the group must
    call this; ranks outside the first `n_devices` get None."""
    dev = torch.device(device)
    if not dist.is_initialized():
        dist.init_process_group("gloo" if dev.type == "cpu" else "nccl",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    group = dist.group.WORLD
    if n_devices is not None and n_devices != world:
        if not 1 <= n_devices <= world:
            raise StitchingError(f"a mesh of {n_devices} in a world of "
                                 f"{world}")
        group = dist.new_group(list(range(n_devices)))
        if dist.get_rank() >= n_devices:
            return None
    backend = str(dist.get_backend(group))
    if dev.type == "cuda":
        dev = _local_cuda(dev)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise StitchingError("an NCCL mesh computes on the card, not on "
                             f"{dev}")
    return Mesh(group, dist.get_world_size(group), dist.get_rank(group), dev,
                backend)


def _wire(x, mesh):
    """The tensor the backend takes for `x`: NCCL reads the card only;
    gloo reads host memory, so a tensor on the card is copied there. Bool
    travels as uint8."""
    if mesh.backend == "nccl" and not x.is_cuda:
        raise StitchingError(f"a {x.device} tensor in an NCCL group")
    x = x.contiguous()
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    return x.cpu() if mesh.backend == "gloo" and x.is_cuda else x


def _back(t, like):
    t = t.to(like.device)
    return t.view(torch.bool) if like.dtype == torch.bool else t


def shard_leading(x, mesh):
    """This rank's contiguous block of `x`'s leading axis (padded with
    zeros to a multiple of D), on `mesh.device`."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    n = x.shape[0]
    b = -(-n // mesh.size)
    blk = x[min(mesh.rank * b, n):min((mesh.rank + 1) * b, n)]
    if blk.shape[0] < b:
        blk = torch.cat([blk, blk.new_zeros((b - blk.shape[0],
                                             *x.shape[1:]))])
    return blk.to(mesh.device)


def replicate(x, mesh):
    """`x` whole on `mesh.device`: every rank holds all of it (the ranks
    hold the same host inputs, SPMD)."""
    return torch.as_tensor(x, device=mesh.device)


def all_gather_leading(x, mesh):
    """Every rank's `x` (one shape on every rank) stacked along the
    leading axis in rank order: (D * x.shape[0], ...) on x's device."""
    t = _wire(x, mesh)
    out = t.new_empty((mesh.size * t.shape[0], *t.shape[1:]))
    # all_gather_into_tensor was renamed all_gather_single in torch 2.13
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, t, group=mesh.group)
    return _back(out, x)


def _all_reduce(x, mesh, op):
    t = _wire(x, mesh)
    dist.all_reduce(t, op=op, group=mesh.group)
    if t is not x:
        x.copy_(_back(t, x))
    return x


def all_reduce_sum(x, mesh):
    """Sum `x` over the ranks, in place; returns x."""
    return _all_reduce(x, mesh, dist.ReduceOp.SUM)


def all_reduce_max(x, mesh):
    """Element-wise maximum of `x` over the ranks, in place; returns x."""
    return _all_reduce(x, mesh, dist.ReduceOp.MAX)


def exchange(sends, recvs, mesh):
    """Point-to-point transfers in one batch (`dist.batch_isend_irecv`).

    sends: {peer rank: tensor}; recvs: {peer rank: (shape, dtype)}.
    Every send must meet the peer's receive of the same shape. Returns
    {peer rank: received tensor on mesh.device}."""
    ranks = dist.get_process_group_ranks(mesh.group)
    ops, bufs = [], {}
    for peer, (shape, dtype) in sorted(recvs.items()):
        like = torch.empty(0, dtype=dtype, device=mesh.device)
        buf = _wire(like, mesh).new_empty(shape)
        bufs[peer] = (buf, like)
        ops.append(dist.P2POp(dist.irecv, buf, ranks[peer], mesh.group))
    for peer, t in sorted(sends.items()):
        ops.append(dist.P2POp(dist.isend, _wire(t, mesh), ranks[peer],
                              mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return {p: _back(buf, like) for p, (buf, like) in bufs.items()}
