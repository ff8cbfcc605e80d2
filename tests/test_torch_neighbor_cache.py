"""The port's device neighbor cache (ops/neighbor_cache.py) against the
JAX package's on seeded random streams, every array exactly equal after
every batch: more than K events of one node in a batch, a self-loop, a
repeated edge, and the empty slots' neighbor ids (which only the top-K
tie rule fixes: equal e_ids keep their column order).  Also the query,
the reset, and the explicit-id merge with padded events (e_id -1)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgb_tgn_dgl_tpu.ops import lean_wire as jlean
from tgb_tgn_dgl_tpu.ops import neighbor_cache as jnc
from tgb_tgn_dgl_tpu_torch.ops.neighbor_cache import (NeighborCacheState,
                                                      init_neighbor_cache,
                                                      insert_events,
                                                      merge_events,
                                                      query_neighbors,
                                                      reset_neighbor_cache)


def _assert_state_equal(got: NeighborCacheState, want, ctx):
    for f in NeighborCacheState._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: {f}")


def _stream(seed, N, B, n_batches):
    """Batches of (src, dst, t) with a hub in a third of each batch's
    events (more than K of one node), a self-loop and a repeated edge."""
    r = np.random.default_rng(seed)
    t = 0.0
    for _ in range(n_batches):
        src = r.integers(0, N, B).astype(np.int32)
        dst = r.integers(0, N, B).astype(np.int32)
        src[r.random(B) < 0.33] = 3
        dst[1] = src[1]                               # self-loop
        src[2], dst[2] = src[0], dst[0]               # repeated edge
        tt = np.sort(t + r.uniform(0, 100, B)).astype(np.float32)
        t = float(tt[-1])
        yield src, dst, tt


@pytest.mark.parametrize("N,K,B,seed", [(50, 4, 64, 0), (12, 3, 40, 1),
                                        (200, 10, 128, 2)],
                         ids=["n50_k4", "hub_dense", "n200_k10"])
def test_insert_events_matches_jax(N, K, B, seed):
    got, want = init_neighbor_cache(N, K), jnc.init_neighbor_cache(N, K)
    _assert_state_equal(got, want, "init")
    partial = 0          # batches after which some row is part empty
    for bi, (src, dst, t) in enumerate(_stream(seed, N, B, 5)):
        got = insert_events(got, *(torch.from_numpy(a)
                                   for a in (src, dst, t)))
        want = jnc.insert_events(want, *(jnp.asarray(a)
                                         for a in (src, dst, t)))
        _assert_state_equal(got, want, f"batch {bi}")
        row_full = (got.e_id >= 0).sum(1)
        partial += bool(((row_full > 0) & (row_full < K)).any())
    assert partial > 0
    ids = torch.tensor([0, 3, N - 1, 3], dtype=torch.int32)
    for a, b in zip(query_neighbors(got, ids),
                    jnc.query_neighbors(want, jnp.asarray(ids.numpy()))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_insert_leaves_its_input_unchanged():
    st = init_neighbor_cache(20, 3)
    before = [t.clone() for t in st]
    src, dst, t = next(_stream(4, 20, 16, 1))
    out = insert_events(st, *(torch.from_numpy(a) for a in (src, dst, t)))
    assert all(torch.equal(a, b) for a, b in zip(st, before))
    assert int(out.cur_e_id) == 16 and (out.e_id >= 0).any()


def test_reset_matches_jax():
    N, K = 30, 4
    got, want = init_neighbor_cache(N, K), jnc.init_neighbor_cache(N, K)
    for src, dst, t in _stream(3, N, 32, 2):
        got = insert_events(got, *(torch.from_numpy(a)
                                   for a in (src, dst, t)))
        want = jnc.insert_events(want, *(jnp.asarray(a)
                                         for a in (src, dst, t)))
    got, want = reset_neighbor_cache(got), jnc.reset_neighbor_cache(want)
    _assert_state_equal(got, want, "reset")
    assert (got.e_id == -1).all() and (got.t == -1.0).all()
    assert int(got.cur_e_id) == 0 and got.neighbors.abs().sum() > 0


def test_merge_with_explicit_ids_and_padding_matches_jax():
    """The device-cache merge: global event ids (the packer's dataset
    rows) and padded events sent to the trash row N with e_id -1, which
    never enter a row."""
    N, K, B = 40, 5, 48
    got = init_neighbor_cache(N + 1, K)
    want = jnc.init_neighbor_cache(N + 1, K)
    row = 1000
    for bi, (src, dst, t) in enumerate(_stream(5, N, B, 4)):
        valid = np.arange(B) < B - 7 * (bi % 2)
        s = np.where(valid, src, N).astype(np.int32)
        d = np.where(valid, dst, N).astype(np.int32)
        eid = np.where(valid, row + np.arange(B), -1).astype(np.int32)
        row += B
        got = merge_events(got, *(torch.from_numpy(a) for a in (s, d, t, eid)))
        want = jlean._insert_with_eid(want, *(jnp.asarray(a)
                                              for a in (s, d, t, eid)))
        _assert_state_equal(got, want, f"batch {bi}")
    assert (got.e_id[N] == -1).all()
