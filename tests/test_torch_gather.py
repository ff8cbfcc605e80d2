"""The memory-row gather (tgb_tgn_dgl_tpu_torch/ops/gather.py) and its
backward kernel (csrc/gather.cu).

On the CPU ``gather_rows`` is ``embedding`` itself, forward and gradient,
and launches nothing.  On the card (``cuda``-marked, skipped here) the
kernel's table gradient is held to a float64 ``index_add_`` within 2e-6
of each row's norm in fp32 and 8e-3 in bf16 (one bf16 rounding of the
output is 2^-9 = 2e-3 of it), rows with no slot are exactly 0, two runs
give the same bits, and a memory train step launches it twice (the
in-edges' gather and the roots').
"""
import pytest
import torch
from torch.nn.functional import embedding

from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.engine.train import Engine
from tgb_tgn_dgl_tpu_torch.ops import gather
from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict

TOL = {torch.float32: 2e-6, torch.bfloat16: 8e-3}


def _keys(kind, S, U, seed, device="cpu"):
    """(S,) int32 row keys in [0, U) of one kind of skew, in slot order
    shuffled."""
    gen = torch.Generator().manual_seed(seed)
    if kind == "skew":
        # the train batch's: 70% on the last (trash) row, 2% on one hub,
        # the rest uniform over the other rows
        n_trash, n_hub = int(0.7 * S), int(0.02 * S)
        rest = torch.randint(0, U - 1, (S - n_trash - n_hub,), generator=gen)
        keys = torch.cat([torch.full((n_trash,), U - 1),
                          torch.full((n_hub,), 17), rest])
    elif kind == "uniform":
        keys = torch.randint(0, U, (S,), generator=gen)
    elif kind == "one_row":
        keys = torch.full((S,), min(3, U - 1))
    elif kind == "even_rows":
        keys = 2 * torch.randint(0, U // 2, (S,), generator=gen)
    else:
        raise ValueError(kind)
    keys = keys[torch.randperm(S, generator=gen)]
    return keys.to(torch.int32).to(device)


def _cpu_table(U, D, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(U, D, generator=gen).to(dtype)


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64],
                         ids=["i32", "i64"])
def test_cpu_gather_rows_is_embedding(idx_dtype, dtype):
    idx = _keys("skew", 12 * 7, 20, seed=1).view(12, 7).to(idx_dtype)
    t1 = _cpu_table(20, 9, dtype, seed=2).requires_grad_(True)
    t2 = t1.detach().clone().requires_grad_(True)
    before = dict(gather.launch_counts)
    out = gather.gather_rows(idx, t1)
    want = embedding(idx.long(), t2)
    assert out.dtype == dtype and torch.equal(out, want)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)
                    ).to(dtype)
    out.backward(g)
    want.backward(g)
    assert torch.equal(t1.grad, t2.grad)
    assert gather.launch_counts == before


def test_cpu_reference_sums_each_rows_slots():
    idx = _keys("even_rows", 300, 10, seed=4)
    g = torch.randn(300, 5, generator=torch.Generator().manual_seed(5))
    got = gather.gather_rows_bwd_reference(idx, g, 10)
    want = torch.ops.aten.embedding_dense_backward(g, idx.long(), 10, -1,
                                                   False)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.all(got[1::2] == 0)


def test_kernel_wrapper_refuses_cpu_tensors():
    idx = _keys("uniform", 64, 8, seed=6)
    with pytest.raises(ValueError, match="CUDA"):
        gather.gather_bwd(idx, torch.zeros(64, 4), 8)


def test_sorted_kernel_wrapper_refuses_cpu_tensors():
    key, slot = torch.sort(_keys("uniform", 64, 8, seed=6), stable=True)
    with pytest.raises(ValueError, match="CUDA"):
        gather.gather_bwd_sorted(key, slot, torch.zeros(64, 4),
                                 torch.zeros(8, 4))


# ----------------------------------------------------------------- card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


CASES = [
    # (keys, S, U, D, dtype, misaligned)
    pytest.param("skew", 1_056_768, 6000, 100, torch.float32, False,
                 id="skew-fp32"),
    pytest.param("skew", 1_056_768, 6000, 100, torch.bfloat16, False,
                 id="skew-bf16"),
    pytest.param("uniform", 200_000, 5000, 100, torch.float32, False,
                 id="uniform"),
    pytest.param("one_row", 300_000, 8, 100, torch.float32, False,
                 id="one_row"),
    pytest.param("even_rows", 50_000, 4000, 100, torch.float32, False,
                 id="empty_rows"),
    pytest.param("one_row", 70_001, 1, 100, torch.float32, False, id="U1"),
    pytest.param("uniform", 16 * 64 * 5 + 37, 300, 100, torch.float32,
                 False, id="ragged"),
    pytest.param("uniform", 5, 3, 100, torch.float32, False, id="tiny"),
    pytest.param("skew", 100_000, 3000, 37, torch.float32, False,
                 id="odd_D-fp32"),
    pytest.param("skew", 100_000, 3000, 37, torch.bfloat16, False,
                 id="odd_D-bf16"),
    pytest.param("skew", 100_000, 3000, 300, torch.float32, False,
                 id="wide_D"),
    pytest.param("skew", 100_000, 3000, 100, torch.float32, True,
                 id="misaligned"),
]


def _case(kind, S, U, D, dtype, misaligned, seed=7):
    keys = _keys(kind, S, U, seed, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(S, D, generator=gen, device="cuda").to(dtype)
    if misaligned:
        buf = torch.empty(S * D + 1, dtype=dtype, device="cuda")
        g = buf[1:].view(S, D).copy_(g)
    return keys, g


@pytest.mark.cuda
@pytest.mark.parametrize("kind,S,U,D,dtype,misaligned", CASES)
def test_cuda_backward_matches_float64_sum(kind, S, U, D, dtype, misaligned):
    _need_cuda()
    keys, g = _case(kind, S, U, D, dtype, misaligned)
    gather.reset_launch_counts()
    got = gather.gather_bwd(keys, g, U)
    torch.cuda.synchronize()
    assert gather.launch_counts == {"gather_bwd": 1}
    assert got.dtype == dtype and tuple(got.shape) == (U, D)
    want = torch.zeros((U, D), dtype=torch.float64, device="cuda")
    want.index_add_(0, keys.long(), g.to(torch.float64))
    err = torch.linalg.vector_norm(got.to(torch.float64) - want, dim=1)
    norm = torch.linalg.vector_norm(want, dim=1)
    used = torch.bincount(keys.long(), minlength=U) > 0
    worst = float((err[used] / norm[used]).max())
    assert worst <= TOL[dtype], f"worst row: {worst:.3e} of its norm"
    assert torch.all(got[~used] == 0), "a row with no slot is not 0"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_gather_rows_forward_and_repeatable_backward(dtype):
    """The forward is ``embedding`` bit for bit; the gradient through
    ``gather_rows`` is the kernel's, and two runs give the same bits."""
    _need_cuda()
    R, Kp, U, D = 24_576, 43, 6000, 100
    keys = _keys("skew", R * Kp, U, seed=8, device="cuda").view(R, Kp)
    gen = torch.Generator(device="cuda").manual_seed(9)
    table = torch.randn(U, D, generator=gen, device="cuda").to(dtype)
    g = torch.randn(R, Kp, D, generator=gen, device="cuda").to(dtype)
    grads = []
    for _ in range(2):
        t = table.clone().requires_grad_(True)
        out = gather.gather_rows(keys, t)
        assert torch.equal(out, embedding(keys.long(), table))
        out.backward(g)
        grads.append(t.grad)
    torch.cuda.synchronize()
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(grads[0], gather.gather_bwd(keys.view(-1),
                                                   g.view(-1, D), U))


@pytest.mark.cuda
def test_cuda_memory_step_launches_two():
    """A memory train step on the card launches the kernel twice: the
    in-edges' gather and the roots'."""
    _need_cuda()
    data = synthetic("tiny", num_edges=1000, num_nodes=100, msg_dim=4,
                     num_neg=8, seed=1)
    raw = dict(sampling=[dict(neighbor=[5])],
               gnn=[dict(att_head=2, dim_out=8, dim_time=8)],
               memory=[dict(dim_out=8, dim_time=8, memory_update="gru")],
               train=[dict(epoch=1, batch_size=100, lr=1e-3, dropout=0.1,
                           att_dropout=0.1, frozen_memory=False)])
    eng = Engine(data, parse_config_dict(raw), device="cuda")
    eng.train_epoch()
    tr = eng.last_epoch_trace
    assert tr["batches"] == 7 and tr["gather_launches"] == 2 * 7
