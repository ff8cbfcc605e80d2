"""The memory-row gather ``table[idx]`` with a load-balanced backward.

``models/tgnn.py`` reads each in-edge's and each root's memory row through
the packer's maps, ``gather_rows(pack.nbr_loc, memory_rows)``; the
gradient into the (U, D) rows is a sum by key over the (R·Kp,) slots,
where the padded columns all point at one trash row (57-79% of a train
batch's slots at the benchmark's batch of 8,000).

``gather_rows`` dispatches on the table's device.  On the CPU it is
``embedding(idx.long(), table)`` itself.  On CUDA it goes through
``_GatherRows``: the same forward (the same kernel, the same bits; no
graph is recorded where no gradient is needed), and a backward that sorts
the slots by row (a stable ``torch.sort`` of the int32 keys) and launches
``gather_bwd`` of ``csrc/gather.cu``, whose work is split by slots and
not by rows, so the trash row's slots are summed by many warps.  There is
no fallback from CUDA to aten's backward: a kernel that fails to build or
launch raises.

``gather_rows_bwd_reference`` is its plain version (a float64
``index_add_``, cast back), for tests.  ``launch_counts`` counts the
launches of each kernel entry point, so a run can show that its main path
went through them.
"""
from __future__ import annotations

import ctypes

import torch
from torch.nn.functional import embedding

from . import _build

KERNELS = ("gather_bwd",)
launch_counts = {name: 0 for name in KERNELS}
DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
# key, slot, g, out, part, piece, done, S, D, bf16, stream
_ARGTYPES = [_P] * 7 + [_I] * 3 + [_P]
_lib: dict = {}


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def launches() -> int:
    """Launches of every entry point since the last reset."""
    return sum(launch_counts.values())


def gather_rows_bwd_reference(idx: torch.Tensor, g: torch.Tensor,
                              num_rows: int) -> torch.Tensor:
    """Plain version: (S,) keys, (S, D) gradient -> (num_rows, D), each
    row the sum of its slots' gradient rows, taken in float64."""
    out = torch.zeros((num_rows, g.shape[1]), dtype=torch.float64,
                      device=g.device)
    return out.index_add_(0, idx.long(), g.to(torch.float64)).to(g.dtype)


def _fn():
    """The entry point and the workspace's layout: (fn, chunk slots, tile
    chunks)."""
    if not _lib:
        lib = _build.library("gather")
        fn = lib.gather_bwd
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _lib.update(fn=fn, chunk=lib.gather_bwd_chunk_slots(),
                    tile=lib.gather_bwd_tile_chunks())
    return _lib["fn"], _lib["chunk"], _lib["tile"]


def _check(idx: torch.Tensor, g: torch.Tensor) -> None:
    dev = g.device
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError(f"gather kernel needs CUDA tensors, got "
                         f"{idx.device} and {dev}")
    if g.dim() != 2 or g.dtype not in DTYPES or not g.is_contiguous():
        raise ValueError(f"gather kernel: the gradient must be a contiguous "
                         f"(S, D) tensor of {DTYPES}; got {g.dtype} "
                         f"{tuple(g.shape)} (contiguous={g.is_contiguous()})")
    S = g.shape[0]
    if tuple(idx.shape) != (S,) or idx.dtype != torch.int32:
        raise ValueError(f"gather kernel: idx must be ({S},) int32; got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if S >= 2 ** 31 - 2 ** 16:
        raise ValueError(f"gather kernel: at most 2**31 - 2**16 slots, "
                         f"got {S}")


def gather_bwd(idx: torch.Tensor, g: torch.Tensor,
               num_rows: int) -> torch.Tensor:
    """Backward kernel: (S,) int32 keys in [0, num_rows), (S, D) gradient
    (fp32 or bf16) -> the table's gradient (num_rows, D) in g's dtype,
    summed in fp32; rows with no slot are 0.  Deterministic: the same
    inputs give the same bits."""
    _check(idx, g)
    S, D = g.shape
    out = torch.zeros((num_rows, D), dtype=g.dtype, device=g.device)
    if S == 0 or D == 0:
        return out
    key, slot = torch.sort(idx, stable=True)
    return gather_bwd_sorted(key, slot, g, out)


def gather_bwd_sorted(key: torch.Tensor, slot: torch.Tensor,
                      g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``gather_bwd`` after its sort: the kernel alone on ``key, slot =
    torch.sort(idx, stable=True)`` (S >= 1), into the zeroed (U, D)
    ``out``, which it returns.  The kernel writes every row that has a
    slot, so a second call into the same ``out`` gives the same bits
    (chip_smoke.py times it so)."""
    _check(key, g)
    S, D = g.shape
    dev = g.device
    if (slot.dtype != torch.int64 or slot.shape != key.shape
            or out.dtype != g.dtype or out.dim() != 2 or out.shape[1] != D
            or not out.is_contiguous() or out.device != dev or S == 0):
        raise ValueError("gather kernel: slot must be the sort's (S,) int64 "
                         "order, S >= 1, and out a contiguous (U, D) tensor "
                         "of the gradient's dtype on its device")
    fn, chunk, tile = _fn()
    chunks = -(-S // chunk)
    tiles = -(-chunks // tile)
    part = torch.empty((2 * chunks, D), dtype=torch.float32, device=dev)
    piece = torch.empty((2 * tiles, D), dtype=torch.float32, device=dev)
    done = torch.zeros(tiles, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(key.data_ptr(), slot.data_ptr(), g.data_ptr(),
                out.data_ptr(), part.data_ptr(), piece.data_ptr(),
                done.data_ptr(), S, D, int(g.dtype == torch.bfloat16),
                stream)
    if rc != 0:
        raise RuntimeError(f"gather_bwd: kernel launch failed with CUDA "
                           f"error {rc}")
    launch_counts["gather_bwd"] += 1
    return out


class _GatherRows(torch.autograd.Function):
    """``embedding(idx, table)`` whose backward is ``gather_bwd``."""

    @staticmethod
    def forward(ctx, idx, table):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return embedding(idx.long(), table)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        D = g.shape[-1]
        d_table = gather_bwd(idx.reshape(-1).to(torch.int32),
                             g.reshape(-1, D).contiguous(), ctx.num_rows)
        return None, d_table


def gather_rows(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for integer ``idx`` of any shape and a (U, D)
    ``table``: ``embedding`` on the CPU, else the same forward with
    ``gather_bwd`` as its backward."""
    if table.device.type == "cpu":
        return embedding(idx.long(), table)
    return _GatherRows.apply(idx, table)
