"""Process groups of the 2-D decomposed grid, one rank per device.

The JAX package runs its fr × R × C mesh (axes ``pod``, ``data``,
``model``) as one SPMD program under ``shard_map``; the port runs one
process per device in a ``torch.distributed`` process group (NCCL on the
card, gloo on the CPU), every rank executing the same host schedule and
the same level loops.  Global ranks are laid out as ``f·R·C + i·C + j``
(replica f, grid row i, grid column j), so that the sorted rank order of
each group — the order ``new_group`` gives its members — is the axis order
the collectives rely on:

  column group  the R ranks (f, ·, j): the expand (``all_gather`` over the
                JAX ``data`` axis) concatenates their owned chunks in
                order of i;
  row group     the C ranks (f, i, ·): the fold (``psum_scatter`` over
                ``model``) hands block j of the partial to rank j;
  grid group    the R·C ranks of replica f: liveness, depth and n_s
                agreement (``psum``/``pmax`` over both grid axes);
  replica group the fr ranks (·, i, j): each replica's per-round results
                travel across the sub-cluster axis (``pod``);
  loop group    replica ∪ grid, every rank: the loop-bound agreement that
                keeps replicas in lockstep under a ring schedule
                (``sync_axes``).

The GNN's 2-D path (models/gnn2d.py) runs the expand and the fold under
autograd: :func:`all_gather_grad` and :func:`reduce_scatter_grad` are each
other's transpose, :func:`sum_shared` sums a value each member uses in
its own way (its backward sums too), and the loss's convention is that
every member computes the loss alike from :func:`sum_loss` terms and
backpropagates its own share, the replicated parameters'
:func:`replicated` summing their gradients over the grid.  Every call
goes through :func:`all_gather`, :func:`reduce_scatter` and
:func:`all_reduce`, so the work counter sees the backward's too.

The ring schedules replace the expand and the fold with point-to-point
hops (:func:`ring_hop`, JAX's ``ppermute`` with device s sending to
s + 1): over the column group rank (f, i, j) sends to ((i + 1) mod R)
and receives from ((i − 1) mod R); over the row group the same in j.
:class:`GridGroups` holds those neighbours' global ranks.

:func:`run_gloo` spawns such a grid of gloo processes on the host (the
CLI's ``--mesh … --device cpu`` and the CPU tests).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

from .. import tracing
from ..device import resolve_device
from ..roofline import counter

__all__ = ["GridGroups", "device_for_rank", "all_gather", "reduce_scatter", "all_reduce",
           "all_gather_grad", "reduce_scatter_grad", "sum_shared", "sum_loss", "replicated",
           "ring_hop", "run_gloo"]


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every member's ``x`` along dim 0, in group-rank order."""
    x = x.contiguous()
    if counter.ACTIVE is not None:
        counter.ACTIVE.collective("all-gather", x.nbytes, group)
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    with tracing.span("bc.collective.all_gather"):
        dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over the members and hand block r of dim 0 to member r."""
    x = x.contiguous()
    if counter.ACTIVE is not None:
        counter.ACTIVE.collective("reduce-scatter", x.nbytes, group)
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),) + tuple(x.shape[1:]))
    with tracing.span("bc.collective.reduce_scatter"):
        dist.reduce_scatter_tensor(out, x, group=group)
    return out


def all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """``x`` reduced with ``op`` over the members, in place; returns ``x``."""
    if counter.ACTIVE is not None:
        counter.ACTIVE.collective("all-reduce", x.nbytes, group)
    with tracing.span("bc.collective.all_reduce"):
        dist.all_reduce(x, op=op, group=group)
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.group), None


class _SumShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), dist.ReduceOp.SUM, ctx.group), None


class _SumLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), dist.ReduceOp.SUM, ctx.group), None


def all_gather_grad(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_gather` under autograd: the backward reduce-scatters the
    cotangent (each member's block summed over every member's copy)."""
    return _AllGather.apply(x, group)


def reduce_scatter_grad(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`reduce_scatter` under autograd: the backward all-gathers the
    cotangent.  Both directions move the dtype they are given, so a
    bf16 payload (cast, collective, cast back) has a bf16 transpose."""
    return _ReduceScatter.apply(x, group)


def sum_shared(x: torch.Tensor, group) -> torch.Tensor:
    """The members' sum of ``x`` (a new tensor) under autograd, for a sum
    that each member then uses in its own way (GAT's softmax
    denominator): the backward sums the members' cotangents."""
    return _SumShared.apply(x, group)


def sum_loss(x: torch.Tensor, group) -> torch.Tensor:
    """The members' sum of ``x`` (a new tensor) under autograd, for the
    terms of a loss that every member then computes alike and seeds with
    1: the backward hands each member its own cotangent, so each member
    backpropagates the loss through its own share only (summing would
    count the one loss once per member)."""
    return _SumLoss.apply(x, group)


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (a parameter every member holds alike) under autograd: the
    forward is the identity, the backward sums the members' cotangents,
    so that with :func:`sum_loss` every member's gradient is the whole
    loss's gradient (the transpose of a replicated input)."""
    return _Replicated.apply(x, group)


def ring_hop(tensors, send_to: int, recv_from: int, group) -> tuple[list, list]:
    """Post one ring hop: send every tensor of ``tensors`` to global rank
    ``send_to`` and receive as many, of the same shapes and dtypes, from
    ``recv_from``, as one ``batch_isend_irecv`` over ``group``.  Returns
    ``(buffers, works)``: fresh receive buffers (the tensors sent are never
    written) and the works to ``wait()`` before reading them (on the card
    that makes the current stream wait, not the host).  The caller skips
    a one-member ring, which has nowhere to send."""
    tensors = [t.contiguous() for t in tensors]
    if counter.ACTIVE is not None:
        counter.ACTIVE.collective("collective-permute", sum(t.nbytes for t in tensors), group,
                                  count=len(tensors))
    bufs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, send_to, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, b, recv_from, group) for b in bufs]
    with tracing.span("bc.collective.ring_hop"):
        return bufs, dist.batch_isend_irecv(ops)


def device_for_rank(device: str | torch.device | None = None) -> torch.device:
    """This rank's device: the CPU when the caller asks for it, otherwise
    the card ``cuda:LOCAL_RANK`` (raises without one), made current."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    dev = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    torch.cuda.set_device(dev)
    return dev


class GridGroups:
    """Rank → (f, i, j), the column, row, grid, replica and loop groups
    of an fr × R × C grid and the global ranks of the rank's ring
    neighbours (see the module docstring), built from the default process
    group.  Every rank must construct it, in the same order
    relative to its other ``new_group`` calls: group creation is
    collective."""

    def __init__(self, fr: int, R: int, C: int):
        if not dist.is_initialized():
            raise RuntimeError("GridGroups needs an initialised default process group")
        if min(fr, R, C) < 1:
            raise ValueError(f"grid dimensions must be >= 1, got {(fr, R, C)}")
        world = dist.get_world_size()
        if world != fr * R * C:
            raise ValueError(
                f"a {fr}x{R}x{C} grid needs {fr * R * C} ranks, the process group has {world}"
            )
        self.fr, self.R, self.C = fr, R, C
        self.rank = dist.get_rank()
        self.f, rem = divmod(self.rank, R * C)
        self.i, self.j = divmod(rem, C)

        def rank_of(f: int, i: int, j: int) -> int:
            return f * R * C + i * C + j

        # every rank creates every group, in one fixed order
        for f in range(fr):
            for j in range(C):
                g = dist.new_group([rank_of(f, i, j) for i in range(R)])
                if (f, j) == (self.f, self.j):
                    self.column = g
            for i in range(R):
                g = dist.new_group([rank_of(f, i, j) for j in range(C)])
                if (f, i) == (self.f, self.i):
                    self.row = g
            g = dist.new_group([rank_of(f, i, j) for i in range(R) for j in range(C)])
            if f == self.f:
                self.grid = g
        for i in range(R):
            for j in range(C):
                g = dist.new_group([rank_of(f, i, j) for f in range(fr)])
                if (i, j) == (self.i, self.j):
                    self.replica = g
        self.loop = None  # replica ∪ grid is every rank: the default group
        # ring neighbours (global ranks): the column ring over i, the row ring over j
        self.col_next = rank_of(self.f, (self.i + 1) % R, self.j)
        self.col_prev = rank_of(self.f, (self.i - 1) % R, self.j)
        self.row_next = rank_of(self.f, self.i, (self.j + 1) % C)
        self.row_prev = rank_of(self.f, self.i, (self.j - 1) % C)

    def gather_vertices(self, x_owned: torch.Tensor) -> torch.Tensor:
        """Every rank's owned ``[chunk, ...]`` slice, assembled on every rank
        in vertex order: ``[fr, n_pad, ...]``, one row per replica.  Device
        (i, j) owns chunk ``j·R + i``, so rank order (row-major) is permuted
        to chunk order (column-major) here."""
        chunk = x_owned.shape[0]
        tail = tuple(x_owned.shape[1:])
        ranks = all_gather(x_owned, None).view((self.fr, self.R, self.C, chunk) + tail)
        return ranks.transpose(1, 2).reshape((self.fr, self.R * self.C * chunk) + tail)

    def gather_replicas(self, x: torch.Tensor) -> torch.Tensor:
        """Each replica's ``x`` (equal on the ranks of a grid), stacked
        ``[fr, ...]`` on every rank."""
        return all_gather(x[None], self.replica)


def _gloo_rank(rank: int, store_path: str, grid: tuple[int, int, int], fn: Callable,
               args: tuple, results) -> None:
    """Body of one spawned gloo rank (see :func:`run_gloo`)."""
    try:
        torch.set_num_threads(1)  # world_size processes share the host's cores
        world = grid[0] * grid[1] * grid[2]
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world
        )
        try:
            out = fn(GridGroups(*grid), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_gloo(fn: Callable, fr: int, R: int, C: int, args: tuple = (), *,
             timeout_s: float = 600.0) -> list[Any]:
    """Run ``fn(groups, *args)`` on an fr × R × C grid of spawned gloo
    processes on the host and return each rank's result, in rank order.

    ``fn`` and ``args`` are pickled to the children, so ``fn`` must be an
    importable module-level function.  The rendezvous is a ``FileStore`` in
    a private temporary directory (no port to collide on).  The first
    failing rank's traceback is raised here; on a failure or after
    ``timeout_s`` every child still running is killed.
    """
    world = fr * R * C
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_gloo_") as tmp:
        procs = [
            ctx.Process(
                target=_gloo_rank,
                args=(rank, os.path.join(tmp, "store"), (fr, R, C), fn, args, results),
                daemon=True,
            )
            for rank in range(world)
        ]
        for p in procs:
            p.start()
        out: dict[int, Any] = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) < world:  # drain before joining
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead:  # a rank died: take its traceback if it left one
                        try:
                            rank, ok, payload = results.get(timeout=5.0)
                        except queue.Empty:
                            raise RuntimeError(
                                f"a gloo rank exited with code {dead[0]} and left no result"
                            ) from None
                    elif time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world - len(out)} of {world} gloo ranks gave no result "
                            f"within {timeout_s:.0f} s"
                        ) from None
                    else:
                        continue
                if not ok:
                    raise RuntimeError(f"gloo rank {rank} failed:\n{payload}")
                out[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=10.0 if len(out) == world else 0.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world)]
