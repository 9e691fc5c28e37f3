"""Multi-device execution on torch.distributed (counterpart of
imagine360_tpu/parallel/mesh.py): the perspective views and the panorama's
latent rows are sharded over the ranks.

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
- The pano branch shards its latent HEIGHT over the same W ranks
  (`shard_pano`; why H and not the frames: the JAX `shard_pano`) when the
  latent height of every UNet stage divides W (`pano_row_mesh`, one rule for
  the whole forward; otherwise the pano is replicated). Rank r holds rows
  [r*H/W, (r+1)*H/W). A 3x3 conv takes one halo row from each neighbour
  (`halo_rows`, zeros beyond the poles), a GroupNorm merges its per-rank
  statistics (`merge_var_mean`), a spatial self-attention gathers its
  keys (`gather_pano`); the rest (1x1 convs, cross-attention, the motion
  modules' frame attention, the FFs) is local to the rows.
- WarpAttn is the only op across the branches. The pano queries need all
  perspective keys, which `gather_views` all-gathers in rank order; the
  perspective queries attend to the whole pano, gathered over the rows
  (or the rank's own copy when it is replicated), under this rank's rows
  of the bias.
- `map_sharded` splits the frame or view batch of a conditioning stage (SAM,
  the VAE) over the ranks and gathers the rows back.
- Training all-reduces every gradient (`all_reduce_grads`), so the
  optimizer runs alike on every rank.
- `shard_frames` and `shard_batch` complete the JAX module's helpers; the
  JAX package calls neither, and nor does this one.

With no active mesh every helper is the identity (one device). A view
layout the mesh cannot take raises: the JAX package's annotations leave
such a layout unsharded, but here that would be W processes doing the same
work.
"""
from __future__ import annotations

import collections
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
# the differentiable collectives run since the last reset, by kind: "gather"
# and "gather_grad" (gather_views, gather_pano and the merged statistics,
# forward and backward), "halo" and "halo_grad" (halo_rows)
_COUNTS: collections.Counter = collections.Counter()


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


def collective_counts() -> dict:
    """The differentiable collectives run since the last reset, by kind
    (gather, gather_grad, halo, halo_grad)."""
    return {k: _COUNTS[k] for k in ("gather", "gather_grad", "halo", "halo_grad")}


def reset_collective_counts() -> None:
    _COUNTS.clear()


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
        _COUNTS["gather"] += 1
        return _all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        _COUNTS["gather_grad"] += 1
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


# ---------------------------------------------------------------------------
# the pano branch's latent rows
# ---------------------------------------------------------------------------


def pano_row_mesh(height: int, levels: int) -> Optional[Mesh]:
    """The mesh over which a pano latent of `height` rows shards its rows
    through a UNet of `levels` stages (heights height / 2**i), or None: no
    mesh, or a stage height that does not divide the world (the pano is
    then replicated). One rule for the whole forward, asked by DualUNet and
    by build_dual_warp_geoms alike."""
    mesh = _ACTIVE
    if mesh is None or height % (mesh.world << (levels - 1)):
        return None
    return mesh


def pano_layout(height: int, levels: int) -> str:
    """pano_row_mesh's choice in words, for the logs."""
    mesh = _ACTIVE
    if mesh is None:
        return "pano whole (no mesh)"
    heights = "/".join(str(height >> i) for i in range(levels))
    if pano_row_mesh(height, levels) is None:
        return f"pano replicated (stage heights {heights} do not all divide {mesh.world} ranks)"
    return (f"pano rows sharded over {mesh.world} ranks (stage heights {heights}, "
            f"{height // mesh.world} rows a rank at the first)")


def shard_pano(x: torch.Tensor, rows: Optional[Mesh], dim: int = 2) -> torch.Tensor:
    """Rank r's rows [r*H/W, (r+1)*H/W) of x along `dim` (the latent height
    of a [B, F, H, W, C] pano), x itself when `rows` is None."""
    if rows is None:
        return x
    n = x.shape[dim] // rows.world
    return x.narrow(dim, rows.rank * n, n)


def gather_pano(x: torch.Tensor, rows: Optional[Mesh], dim: int = 2) -> torch.Tensor:
    """Every rank's rows of x along `dim`, in rank order (the inverse of
    shard_pano); differentiable as gather_views. x itself when `rows` is
    None."""
    if rows is None:
        return x
    return _GatherViews.apply(x, dim)


class _HaloRows(torch.autograd.Function):
    """Forward: x with one row of each neighbour rank on either side along
    `dim` (the previous rank's last row above, the next rank's first row
    below; zeros beyond the first and the last rank), by one all-gather of
    every rank's first and last row. Backward: each halo row's gradient goes
    back to the rank that owns the row (one all-gather again) and is added
    to that row's gradient."""

    @staticmethod
    def forward(ctx, x, dim, rank, world):
        ctx.dim, ctx.rank, ctx.world = dim, rank, world
        _COUNTS["halo"] += 1
        edges = _all_gather(torch.stack([x.select(dim, 0), x.select(dim, -1)]), 0)
        zero = torch.zeros_like(x.select(dim, 0))
        above = edges[2 * rank - 1] if rank > 0 else zero
        below = edges[2 * rank + 2] if rank < world - 1 else zero
        return torch.cat([above.unsqueeze(dim), x, below.unsqueeze(dim)], dim)

    @staticmethod
    def backward(ctx, g):
        dim, rank, world = ctx.dim, ctx.rank, ctx.world
        _COUNTS["halo_grad"] += 1
        edges = _all_gather(torch.stack([g.select(dim, 0), g.select(dim, -1)]), 0)
        dx = g.narrow(dim, 1, g.shape[dim] - 2).clone()
        if rank > 0:            # the previous rank's halo below is this rank's first row
            dx.select(dim, 0).add_(edges[2 * rank - 1])
        if rank < world - 1:    # the next rank's halo above is this rank's last row
            dx.select(dim, -1).add_(edges[2 * rank + 2])
        return dx, None, None, None


def halo_rows(x: torch.Tensor, rows: Mesh, dim: int) -> torch.Tensor:
    """x with one halo row on either side along `dim`: the neighbouring
    ranks' edge rows, zeros beyond the poles (the pano's height is
    zero-padded, only its width wraps). Differentiable. Every rank of
    `rows` must call it, at world size 1 too."""
    return _HaloRows.apply(x.contiguous(), dim % x.dim(), rows.rank, rows.world)


def merge_var_mean(var: torch.Tensor, mean: torch.Tensor, rows: Mesh):
    """The (variance, mean) over every rank's rows, from each rank's own
    population variance and mean over an equal count of elements (Chan's
    merge: a bare sum and sum of squares would lose the digits of a large
    mean). Differentiable through the gather."""
    stats = gather_pano(torch.stack([var, mean])[None], rows, 0)    # [W, 2, ...]
    v, m = stats.unbind(1)
    mean_all = m.mean(0)
    return (v + (m - mean_all) ** 2).mean(0), mean_all


# ---------------------------------------------------------------------------
# the rest of the JAX module's helpers (the JAX package calls neither)
# ---------------------------------------------------------------------------


def _block(x: torch.Tensor, dim: int, n_ranks: int, index: int) -> torch.Tensor:
    """Block `index` of `n_ranks` along `dim`; x itself where the dimension
    does not divide (it stays whole, as the JAX _constrain leaves it)."""
    if n_ranks <= 1 or x.shape[dim] % n_ranks:
        return x
    n = x.shape[dim] // n_ranks
    return x.narrow(dim, index * n, n)


def shard_frames(x: torch.Tensor) -> torch.Tensor:
    """This rank's frames of [B, F, ...]: the frames (dim 1) over the view
    ranks, the clips (dim 0) over the replicas. Ranks are replica-major,
    rank = replica * view_size + view, as the JAX make_mesh lays the
    devices out."""
    mesh = _ACTIVE
    if mesh is None:
        return x
    replica, view = divmod(mesh.rank, mesh.view_size)
    return _block(_block(x, 0, mesh.replicas, replica), 1, mesh.view_size, view)


def shard_batch(x: torch.Tensor) -> torch.Tensor:
    """This rank's replica block of the leading axis (training batches)."""
    mesh = _ACTIVE
    if mesh is None:
        return x
    return _block(x, 0, mesh.replicas, mesh.rank // mesh.view_size)
