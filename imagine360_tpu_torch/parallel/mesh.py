"""Multi-device execution on torch.distributed (counterpart of
imagine360_tpu/parallel/mesh.py): the perspective views are sharded over the
ranks and the panorama is replicated.

In the JAX package GSPMD inserts the collectives from sharding annotations.
Torch has no GSPMD, so here every rank computes its own rows and the
collectives are written out:

- The process group spans W = replicas x view-size ranks, taken from the
  torchrun environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT):
  NCCL on the card, rank r on cuda:LOCAL_RANK, gloo on the CPU. Every caller
  runs one clip at a time (B = 1), so the replica axis joins the view axis
  for the view fold, as the JAX `shard_views` does with lead=(replica,
  view): the views shard over all W ranks.
- Rank r holds views [r*M/W, (r+1)*M/W) of every CFG half (`shard_views`),
  so the CFG combine stays local.
- WarpAttn is the only op across the branches. The pano queries need all
  perspective keys, which `gather_views` all-gathers in rank order; the
  perspective queries attend to the rank's own copy of the pano under this
  rank's rows of the bias.
- `map_sharded` splits the frame or view batch of a conditioning stage (SAM,
  the VAE) over the ranks and gathers the rows back.
- Training all-reduces every gradient (`all_reduce_grads`), so the
  optimizer runs alike on every rank.

With no active mesh every helper is the identity (one device). A layout the
mesh cannot take raises: the JAX package's annotations leave such a layout
unsharded, but here that would be W processes doing the same work.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Callable, Iterable, Iterator, Optional

import torch
import torch.distributed as dist

# a collective that waits longer than this raises (gloo) or ends the process
# (NCCL), so a rank whose peer failed ends in an error rather than a hang
TIMEOUT = datetime.timedelta(seconds=600)
USE_MESH = ("off", "auto", "on")

_ACTIVE: Optional["Mesh"] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the ('replica', 'view') layout over the default
    process group."""
    world: int
    rank: int
    replicas: int
    device: torch.device

    @property
    def view_size(self) -> int:
        return self.world // self.replicas


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else _env_int("WORLD_SIZE", 1)


def check_layout(world: int, replicas: int, views: Optional[int] = None) -> None:
    """`replicas` must divide the world (as make_mesh asserts in the JAX
    package) and `views`, where given, must divide over the world."""
    if replicas < 1 or world % replicas:
        raise ValueError(f"mesh_replicas {replicas} does not divide the world size {world}")
    if views is not None and views % world:
        fits = [n for n in range(1, views + 1) if views % n == 0]
        raise ValueError(f"{views} views do not divide over {world} ranks: the world size "
                         f"must be one of {fits}")


def make_mesh(replicas: int = 1, device="cpu", views: Optional[int] = None) -> Mesh:
    """This rank's mesh over the default process group, which is joined
    here when it is not yet: from the torchrun environment, or alone (world
    size 1, an in-process store) outside torchrun. `device` "cuda" is this
    rank's card, cuda:LOCAL_RANK, under NCCL; "cpu" takes gloo. The layout
    (check_layout) is checked before the group is joined."""
    world = _world_size()
    rank = dist.get_rank() if dist.is_initialized() else _env_int("RANK", 0)
    check_layout(world, replicas, views)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", _env_int("LOCAL_RANK", 0))
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        # with the rank's card named, NCCL builds its communicator here and
        # not inside the first collective of the first step
        kw = dict(backend=backend, world_size=world, rank=rank, timeout=TIMEOUT,
                  device_id=dev if dev.type == "cuda" else None)
        if "MASTER_ADDR" in os.environ:
            dist.init_process_group(init_method="env://", **kw)
        elif world == 1:
            dist.init_process_group(store=dist.HashStore(), **kw)
        else:
            raise ValueError(f"WORLD_SIZE {world} without MASTER_ADDR: start the ranks "
                             "with torchrun")
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, but {dev} needs "
                         f"{backend}")
    return Mesh(world, rank, replicas, dev)


def init_from_config(run_cfg, device="cuda", views: Optional[int] = None) -> Optional[Mesh]:
    """The mesh that `run_cfg.use_mesh` and `mesh_replicas` ask for (the
    JAX pipeline's rule): "off" none, and a world of several ranks raises,
    since each would do the whole run; "auto" a mesh when WORLD_SIZE > 1;
    "on" always, of world size 1 outside torchrun."""
    mode, world = run_cfg.use_mesh, _world_size()
    if mode not in USE_MESH:
        raise ValueError(f"use_mesh {mode!r}: one of {', '.join(USE_MESH)}")
    if mode == "off":
        if world > 1:
            raise ValueError(f"use_mesh: off on a world of {world} ranks: each rank would "
                             "run the whole clip; set use_mesh auto or on, or start one "
                             "process")
        return None
    if mode == "auto" and world == 1:
        return None
    return make_mesh(run_cfg.mesh_replicas, device, views)


@contextlib.contextmanager
def activate_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Makes the helpers below shard over `mesh` (None: one device)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def current_mesh() -> Optional[Mesh]:
    return _ACTIVE


def destroy() -> None:
    """Leave the default process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def view_slice(views: int) -> slice:
    """This rank's views of `views`: [r*M/W, (r+1)*M/W), all of them with no
    mesh. Raises where the views do not divide over the world."""
    mesh = _ACTIVE
    if mesh is None:
        return slice(0, views)
    check_layout(mesh.world, mesh.replicas, views)
    n = views // mesh.world
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_views(x: torch.Tensor, dim: int = 0, batch: int = 1) -> torch.Tensor:
    """This rank's views of x. `dim` holds batch x M entries, batch-major
    (the CFG fold [2*M] of the perspective branch has batch=2): this rank
    keeps its views of every batch entry."""
    if _ACTIVE is None:
        return x
    n = x.shape[dim] // batch
    sl = view_slice(n)
    if batch == 1:
        return x.narrow(dim, sl.start, sl.stop - sl.start)
    return x.unflatten(dim, (batch, n)).narrow(dim + 1, sl.start, sl.stop - sl.start) \
        .flatten(dim, dim + 1)


def _all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=dim)


class _GatherViews(torch.autograd.Function):
    """Forward: every rank's x, concatenated along `dim` in rank order.
    Backward: the sum over the ranks of the incoming gradient (each rank
    used the whole gathered tensor), then this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        return _all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g.narrow(ctx.dim, dist.get_rank() * ctx.n, ctx.n), None


def gather_views(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's views of x along `dim`, in rank order (the inverse of
    shard_views with batch=1); differentiable. The identity with no mesh."""
    if _ACTIVE is None:
        return x
    return _GatherViews.apply(x, dim)


def map_sharded(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """fn(x) with the leading (frame or view) axis split over the world:
    each rank runs fn on its rows and the rows are gathered back. fn must
    treat the rows independently. A batch that does not divide the world
    runs whole on every rank, as the JAX pipeline's _stage_mesh leaves it
    unsharded. For the conditioning stages, without grad."""
    mesh = _ACTIVE
    if mesh is None or x.shape[0] % mesh.world:
        return fn(x)
    n = x.shape[0] // mesh.world
    return _all_gather(fn(x.narrow(0, mesh.rank * n, n)), 0)


def all_reduce_grads(tensors: Iterable[torch.Tensor]) -> None:
    """Sum each tensor over the world in place, in the caller's order (the
    same on every rank). A no-op with no mesh."""
    if _ACTIVE is None:
        return
    for t in tensors:
        dist.all_reduce(t)


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the world (x itself with no mesh)."""
    if _ACTIVE is None:
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x
