"""The collectives of the port's parallel paths, each an autograd
``Function`` whose backward is its adjoint.  In the JAX package these are
what GSPMD inserts from sharding annotations (and what ``shard_map``'s
``ppermute``/``psum`` transpose to); here every one is an explicit call on
a process group of a ``parallel.mesh.Mesh`` axis.

Two conventions for what a group's ranks hold in common:

- *sum* (the ``data`` and ``seq`` axes): each rank's loss is its own share
  of the objective, which is their sum.  An all-gather's adjoint is then a
  reduce-scatter, an all-reduce's an all-reduce, an all-to-all's the
  reverse all-to-all, a hop to the right neighbour's a hop to the left.
- *replicated* (the ``model`` and ``stage`` axes, Megatron's): every rank of
  the group computes the same loss.  ``copy_to`` (identity forward,
  all-reduce backward) enters a rank-local computation from a replicated
  value, ``reduce_from`` (all-reduce forward, identity backward) leaves it,
  and ``gather_from`` gathers with its own slice as the backward.

Complex tensors travel as ``torch.view_as_real``.  Every function calls
its collective at any group size, 1 included, so a one-card run goes
through the backend (NCCL there) as a larger one would.  The pipeline's
send/receive and broadcast are plain calls here: ``parallel/pipeline.py``
wraps its whole schedule in one Function whose backward runs their
adjoints in the reverse schedule.  ``CALLS`` counts
the collectives launched, by kind, forward and backward alike, as
``kernels/*.LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

KINDS = ("all_to_all", "all_gather", "reduce_scatter", "all_reduce",
         "all_reduce_max", "copy_to", "reduce_from", "gather_from", "halo",
         "stage", "broadcast")
CALLS = collections.Counter({k: 0 for k in KINDS})


def reset_calls() -> None:
    for k in KINDS:
        CALLS[k] = 0


def _real(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


def _like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y (real, laid out as ``_real(x)``) back in x's type."""
    return torch.view_as_complex(y.contiguous()) if x.is_complex() else y


def _all_reduce(x: torch.Tensor, mesh, axis: str, kind: str,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    CALLS[kind] += 1
    y = _real(x).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=mesh.group(axis))
    return _like(y, x)


def _all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
                cat_dim: int) -> torch.Tensor:
    """x cut into ``size`` pieces along split_dim, piece q sent to rank q;
    the pieces received, concatenated along cat_dim in rank order."""
    CALLS["all_to_all"] += 1
    size = mesh.size(axis)
    n = x.shape[split_dim]
    if n % size:
        raise ValueError(f"all_to_all: dim {split_dim} of size {n} does not "
                         f"split over {size} ranks")
    xr = _real(x).movedim(split_dim, 0).contiguous()
    out = torch.empty_like(xr)
    dist.all_to_all_single(out, xr, group=mesh.group(axis))
    # (source rank, piece...) with the piece in x's layout
    out = out.reshape(size, n // size, *xr.shape[1:]).movedim(
        1, split_dim + 1)
    return _like(out.movedim(0, cat_dim).flatten(cat_dim, cat_dim + 1)
                 .contiguous(), x)


def _all_gather(x: torch.Tensor, mesh, axis: str, dim: int, kind: str
                ) -> torch.Tensor:
    CALLS[kind] += 1
    size = mesh.size(axis)
    xr = _real(x).movedim(dim, 0).contiguous()
    out = xr.new_empty((size * xr.shape[0], *xr.shape[1:]))
    dist.all_gather_into_tensor(out, xr, group=mesh.group(axis))
    return _like(out.movedim(0, dim).contiguous(), x)


def _reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int
                    ) -> torch.Tensor:
    CALLS["reduce_scatter"] += 1
    size = mesh.size(axis)
    xr = _real(x).movedim(dim, 0).contiguous()
    out = xr.new_empty((xr.shape[0] // size, *xr.shape[1:]))
    dist.reduce_scatter_tensor(out, xr, group=mesh.group(axis))
    return _like(out.movedim(0, dim).contiguous(), x)


def _shift(x: torch.Tensor, mesh, axis: str, step: int, kind: str
           ) -> torch.Tensor:
    """Rank r's x to rank (r + step) mod size, as one all-to-all whose
    only nonempty piece goes to that rank (a send to oneself is how a
    group of one runs it)."""
    CALLS[kind] += 1
    size, rank = mesh.size(axis), mesh.rank(axis)
    xr = _real(x).contiguous().reshape(-1)
    sends = [0] * size
    recvs = [0] * size
    sends[(rank + step) % size] = xr.numel()
    recvs[(rank - step) % size] = xr.numel()
    out = torch.empty_like(xr)
    dist.all_to_all_single(out, xr, recvs, sends, group=mesh.group(axis))
    return _like(out.reshape(_real(x).shape), x)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, cat_dim):
        ctx.args = (mesh, axis, split_dim, cat_dim)
        return _all_to_all(x, mesh, axis, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, cat_dim = ctx.args
        return _all_to_all(g, mesh, axis, cat_dim, split_dim), None, None, \
            None, None


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               cat_dim: int) -> torch.Tensor:
    """Reshard along ``axis``: x split along ``split_dim`` (which leaves
    sharded) and gathered along ``cat_dim`` (which becomes sharded).
    Adjoint: the reverse all-to-all."""
    nd = x.dim()
    return _AllToAll.apply(x, mesh, axis, split_dim % nd, cat_dim % nd)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _all_gather(x, mesh, axis, dim, "all_gather")

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return _reduce_scatter(g, mesh, axis, dim), None, None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' x concatenated along ``dim`` in rank order (sum
    convention).  Adjoint: a reduce-scatter (sum)."""
    return _AllGather.apply(x, mesh, axis, dim % x.dim())


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim, x.shape[dim])
        return _all_gather(x, mesh, axis, dim, "gather_from")

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, n = ctx.args
        r = mesh.rank(axis)
        return g.narrow(dim, r * n, n).contiguous(), None, None, None


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' x concatenated along ``dim`` (replicated convention: every
    rank goes on with the same whole).  Adjoint: the rank's own slice."""
    return _GatherFrom.apply(x, mesh, axis, dim % x.dim())


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return _all_reduce(x, mesh, axis, "all_reduce")

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return _all_reduce(g, mesh, axis, "all_reduce"), None, None


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum over the ranks (sum convention).  Adjoint: the same sum."""
    return _AllReduce.apply(x, mesh, axis)


def all_reduce_max(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Elementwise max over the ranks, without a gradient (a softmax's
    stabiliser, whose value the result does not depend on)."""
    return _all_reduce(x.detach(), mesh, axis, "all_reduce_max",
                       dist.ReduceOp.MAX)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return _all_reduce(g, mesh, axis, "copy_to"), None, None


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Identity; the backward sums the ranks' cotangents (Megatron's f)."""
    return _CopyTo.apply(x, mesh, axis)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis, "reduce_from")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum over the ranks; the backward is the identity (Megatron's g)."""
    return _ReduceFrom.apply(x, mesh, axis)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        y = _shift(x, mesh, axis, 1, "halo")
        return torch.zeros_like(y) if mesh.rank(axis) == 0 else y

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        if mesh.rank(axis) == 0:
            g = torch.zeros_like(g)
        return _shift(g, mesh, axis, -1, "halo"), None, None


def halo_right(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Rank r receives rank r-1's x; rank 0 receives zeros (the sequence's
    start).  Adjoint: the hop to the left, the last rank's cotangent
    dropped."""
    return _Halo.apply(x, mesh, axis)


def stage_send_recv(x: torch.Tensor, mesh, axis: str, step: int = 1
                    ) -> torch.Tensor:
    """Each stage sends x to stage (r + step) mod P and returns what it
    received (JAX's ring ``ppermute``), outside autograd: the pipeline's
    Function runs the adjoint, the ring the other way, in its backward
    schedule (``parallel/pipeline.py``)."""
    return _shift(x, mesh, axis, step, "stage")


@torch.no_grad()
def broadcast(x: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """Rank ``src``'s x on every rank of the axis, outside autograd."""
    CALLS["broadcast"] += 1
    y = _real(x).clone(memory_format=torch.contiguous_format)
    group = mesh.group(axis)
    dist.broadcast(y, src=dist.get_global_rank(group, src), group=group)
    return _like(y, x)


@torch.no_grad()
def sum_(tensors, mesh, axis: str) -> None:
    """Sum a list of same-dtype tensors over the ranks in place, as one
    flat all-reduce (gradients, outside autograd)."""
    if not tensors:
        return
    CALLS["all_reduce"] += 1
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group(axis))
    torch._foreach_copy_(tensors, [
        piece.view_as(t) for piece, t in zip(
            flat.split([t.numel() for t in tensors]), tensors)])


@torch.no_grad()
def gather_tensor(x: torch.Tensor, mesh, axis: str, dim: int
                  ) -> torch.Tensor:
    """The ranks' x concatenated along ``dim``, outside autograd (sharded
    state gathered for a checkpoint)."""
    return _all_gather(x, mesh, axis, dim % x.dim(), "all_gather")
