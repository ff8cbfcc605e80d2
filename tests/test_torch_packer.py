"""The port's copied host layer (dataset, dependency leveler, StreamPacker)
gives the JAX package's packs bit for bit on the same stream: train
batches, eval chunks that leave the stream state alone (insert and
write_mail off) and the chunk that advances it.  Exact equality: both are
the same numpy code."""
import numpy as np
import pytest
import torch

from tgb_tgn_dgl_tpu.data import dataset as jdata
from tgb_tgn_dgl_tpu.data.dependency import get_block as jax_get_block
from tgb_tgn_dgl_tpu.data.packer import (PackerConfig as JaxPackerConfig,
                                         StreamPacker as JaxStreamPacker)
from tgb_tgn_dgl_tpu.engine.negatives import \
    NegLinkSamplerDest as JaxNegSampler
from tgb_tgn_dgl_tpu_torch.data import dataset as pdata
from tgb_tgn_dgl_tpu_torch.data.dependency import (dependency_aware_batch,
                                                   get_block)
from tgb_tgn_dgl_tpu_torch.data.packer import (DevicePack, PackerConfig,
                                               StreamPacker, to_device)
from tgb_tgn_dgl_tpu_torch.engine.negatives import NegLinkSamplerDest


def _assert_same_pack(a, b):
    for f in DevicePack._fields:
        x, y = getattr(a, f), getattr(b, f)
        if y is None:                  # nbr_rslot at one layer
            assert x is None, f
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("num_blocks", "num_real_events", "num_real_roots"):
        assert getattr(a, f) == getattr(b, f), f


def test_synthetic_stream_is_identical():
    a = pdata.synthetic("tgbl-wiki-small", num_edges=500, num_nodes=60,
                        msg_dim=6, num_neg=5, seed=2)
    b = jdata.synthetic("tgbl-wiki-small", num_edges=500, num_nodes=60,
                        msg_dim=6, num_neg=5, seed=2)
    for f in ("src", "dst", "t", "msg", "train_mask", "val_mask",
              "test_mask", "val_ns", "test_ns"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("max_intra", [None, 2], ids=["exact", "capped"])
def test_packs_equal_jax(max_intra):
    data = pdata.synthetic("tgbl-wiki-small", num_edges=700, num_nodes=70,
                           msg_dim=4, num_neg=6, seed=3)
    B = 100
    mine = StreamPacker(data.num_nodes, PackerConfig(
        num_neighbors=4, batch_size=B, max_intra_block=max_intra,
        mailbox_size=2))
    ref = JaxStreamPacker(data.num_nodes, JaxPackerConfig(
        num_neighbors=4, batch_size=B, max_intra_block=max_intra,
        mailbox_size=2))
    s_mine = NegLinkSamplerDest(data.unique_dst(), seed=0)
    s_ref = JaxNegSampler(data.unique_dst(), seed=0)
    rows_all = np.nonzero(data.train_mask)[0]
    blocks = dependency_aware_batch(data.src[rows_all], data.dst[rows_all], B)
    for lo in range(0, 300, B):
        rows = rows_all[lo:lo + B]
        src, dst, t = data.src[rows], data.dst[rows], data.t[rows]
        blk = blocks[lo:lo + B]
        np.testing.assert_array_equal(blk, jax_get_block(src, dst))
        neg = s_mine.sample(dst)
        np.testing.assert_array_equal(neg, s_ref.sample(dst))
        _assert_same_pack(mine.pack(src, dst, t, rows, blk, neg),
                          ref.pack(src, dst, t, rows, blk, neg))
    # eval chunks: state frozen on all but the last chunk
    vrows = np.nonzero(data.val_mask)[0][:B]
    src, dst, t = data.src[vrows], data.dst[vrows], data.t[vrows]
    blk = get_block(src, dst)
    negs = data.val_ns[:B]
    for cols, last in ((slice(0, 4), False), (slice(4, 6), True)):
        kw = dict(eval_mode=True, insert=last, write_mail=last)
        _assert_same_pack(mine.pack(src, dst, t, vrows, blk, negs[:, cols],
                                    **kw),
                          ref.pack(src, dst, t, vrows, blk, negs[:, cols],
                                   **kw))
    for x, y in zip(mine.snapshot(), ref.snapshot()):
        np.testing.assert_array_equal(x, y)


def test_to_device_keeps_every_field():
    data = pdata.synthetic("tgbl-wiki-small", num_edges=200, num_nodes=30,
                           msg_dim=3, num_neg=2, seed=4)
    packer = StreamPacker(data.num_nodes, PackerConfig(num_neighbors=3,
                                                       batch_size=50))
    rows = np.arange(50)
    src, dst, t = data.src[rows], data.dst[rows], data.t[rows]
    pack = packer.pack(src, dst, t, rows, get_block(src, dst), dst[::-1])
    dp = to_device(pack, "cpu")
    for f in DevicePack._fields:
        got = getattr(dp, f)
        if getattr(pack, f) is None:   # nbr_rslot at one layer
            assert got is None, f
            continue
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), getattr(pack, f))


def test_snapshot_restore_roundtrip():
    data = pdata.synthetic("tgbl-wiki-small", num_edges=200, num_nodes=30,
                           msg_dim=3, num_neg=2, seed=5)
    packer = StreamPacker(data.num_nodes, PackerConfig(num_neighbors=3,
                                                       batch_size=50))
    rows = np.arange(50)
    src, dst, t = data.src[rows], data.dst[rows], data.t[rows]
    blk = get_block(src, dst)
    snap = packer.snapshot()
    first = packer.pack(src, dst, t, rows, blk, dst[::-1])
    packer.restore(snap)
    _assert_same_pack(first, packer.pack(src, dst, t, rows, blk, dst[::-1]))
