"""The (dp, state) process mesh of the sharded engine on torch.distributed:
the port's counterpart of tgb_tgn_dgl_tpu/parallel/mesh.py.

The JAX mesh lays devices out as ``devices.reshape(dp, state)`` and lets
GSPMD derive the collectives from the shardings.  Here the mesh is the
ranks of one process group, laid out the same way (rank r = d·state + s),
and it owns the collectives the sharded steps call, written out:

  "dp"    — ranks with the same state index s: each embeds and scores its
            share of a batch's root slots and events (parallel/sharded.py);
            the embedding table and the scores are all-gathered over it,
            the gradients all-reduced;
  "state" — ranks with the same dp index d: together they hold one copy of
            the node memory, row-sharded; a read gathers over it.

The backend is named by the caller, never discovered.  NCCL takes CUDA
tensors as they are; gloo takes host tensors, so a CUDA tensor on gloo
crosses to the host and back in every call (two ranks on one card, which
NCCL refuses).  The backend fixes the path before the first call, and a
failed collective raises.  An axis of one rank needs no collective: the
call returns its input, so a world of one computes what the serial Engine
computes.

All-gathers move raw bytes (any dtype, bool included, crosses exactly);
all-reduces sum in the tensor's own dtype.  ``stats`` counts the calls, the
bytes sent and the host seconds spent in collectives.
"""
from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def world() -> tuple:
    """(size, rank) of the default process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """The ranks of the default process group (or the one process) as a
    (dp, state) grid; ``d``, ``s`` are this rank's indices."""

    def __init__(self, dp: int, state: int, backend: str = "gloo"):
        size, rank = world()
        if dp < 1 or state < 1 or dp * state != size:
            raise ValueError(f"mesh dp({dp}) x state({state}) != world size "
                             f"{size}")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: expected one of "
                             f"{list(BACKENDS)}")
        if size > 1 and dist.get_backend() != backend:
            raise ValueError(f"mesh backend {backend!r}, process group "
                             f"backend {dist.get_backend()!r}")
        self.dp, self.state, self.backend = dp, state, backend
        self.rank = rank
        self.d, self.s = divmod(rank, state)
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
        self._groups = {"dp": None, "state": None}
        if size > 1:
            # new_group is collective: every rank builds every group, in
            # one order; a group's rank order is its members' index
            for s in range(state):
                g = dist.new_group([d * state + s for d in range(dp)])
                if s == self.s:
                    self._groups["dp"] = g
            for d in range(dp):
                g = dist.new_group([d * state + s for s in range(state)])
                if d == self.d:
                    self._groups["state"] = g

    @property
    def shape(self):
        return {"dp": self.dp, "state": self.state}

    def size(self, axis: str) -> int:
        return self.dp if axis == "dp" else self.state

    def index(self, axis: str) -> int:
        return self.d if axis == "dp" else self.s

    def share(self, n: int, axis: str = "dp") -> slice:
        """This rank's contiguous 1/size share of ``n`` rows on ``axis``."""
        k = self.size(axis)
        if n % k:
            raise ValueError(f"{n} rows do not split over {axis}={k}")
        i = self.index(axis)
        return slice(i * n // k, (i + 1) * n // k)

    # ----------------------------------------------------------- collectives
    def _count(self, t0: float, nbytes: int) -> None:
        self.stats["calls"] += 1
        self.stats["bytes"] += nbytes
        self.stats["seconds"] += time.perf_counter() - t0

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Concatenate every rank's ``t`` of ``axis`` along dim 0, in the
        axis's rank order (same shape on every rank)."""
        k = self.size(axis)
        if k == 1:
            return t
        t0 = time.perf_counter()
        src = t.detach().contiguous()
        # rows of raw bytes: every dtype crosses, and exactly
        raw = (src.flatten(1) if src.dim() > 1 else src[:, None]).view(
            torch.uint8)
        group = self._groups[axis]
        if self.backend == "nccl":
            out = torch.empty((k * raw.shape[0], *raw.shape[1:]),
                              dtype=torch.uint8, device=raw.device)
            dist.all_gather_into_tensor(out, raw, group=group)
        else:
            host = raw.cpu()
            parts = [torch.empty_like(host) for _ in range(k)]
            dist.all_gather(parts, host, group=group)
            out = torch.cat(parts).to(t.device)
        self._count(t0, raw.numel())
        return out.view(src.dtype).reshape((k * src.shape[0],
                                            *src.shape[1:]))

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of every rank's ``t`` of ``axis`` (a new tensor)."""
        if self.size(axis) == 1:
            return t
        t0 = time.perf_counter()
        group = self._groups[axis]
        if self.backend == "nccl":
            out = t.detach().clone()
            dist.all_reduce(out, group=group)
        else:
            host = t.detach().cpu().clone()
            dist.all_reduce(host, group=group)
            out = host.to(t.device)
        self._count(t0, t.numel() * t.element_size())
        return out

    def reduce_scatter(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """This rank's dim-0 share of the sum of every rank's ``t``."""
        k = self.size(axis)
        if k == 1:
            return t
        if self.backend == "nccl":
            t0 = time.perf_counter()
            out = torch.empty((t.shape[0] // k, *t.shape[1:]), dtype=t.dtype,
                              device=t.device)
            dist.reduce_scatter_tensor(out, t.contiguous(),
                                       group=self._groups[axis])
            self._count(t0, t.numel() * t.element_size())
            return out
        # gloo has no reduce-scatter: the whole sum, then this rank's share
        return self.all_reduce(t, axis)[self.share(t.shape[0], axis)]


def mesh_shape(n: int, dp: Optional[int] = None,
               state: Optional[int] = None) -> dict:
    """The (dp, state) of ``n`` ranks with the JAX defaults: a 2-way state
    axis when n >= 4 and even, else 1; the axis not given is n over the
    other (tgb_tgn_dgl_tpu parallel/mesh.py:31-45)."""
    if dp is None and state is None:
        state = 2 if n % 2 == 0 and n >= 4 else 1
        dp = n // state
    elif dp is None:
        dp = n // state
    elif state is None:
        state = n // dp
    if dp * state != n:
        raise ValueError(f"dp({dp}) * state({state}) != ranks({n})")
    return {"dp": dp, "state": state}


def make_mesh(n: Optional[int] = None, dp: Optional[int] = None,
              state: Optional[int] = None, backend: str = "gloo") -> Mesh:
    """The mesh of ``mesh_shape(n, dp, state)`` over the process group, n
    the world size when None."""
    shape = mesh_shape(n or world()[0], dp, state)
    return Mesh(shape["dp"], shape["state"], backend)


class _GatherRows(torch.autograd.Function):
    """All-gather over an axis whose backward is the reduce-scatter: each
    rank's gradient of its rows is the sum over the ranks that read them."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_gather(t, axis)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.reduce_scatter(grad, ctx.axis), None, None


def gather_rows(t: torch.Tensor, mesh: Mesh, axis: str = "dp"
                ) -> torch.Tensor:
    """``mesh.all_gather`` that carries autograd when ``t`` needs it."""
    if mesh.size(axis) == 1:
        return t
    if t.requires_grad:
        return _GatherRows.apply(t, mesh, axis)
    return mesh.all_gather(t, axis)
