"""The port's on-disk readers (tgb_tgn_dgl_tpu_torch/data/dataset.py:
``load_tgb``, ``_load_tgb_processed``, ``load_tgl_data``) against the JAX
package's on fixture files each test writes itself: the tgb package's
'ml_' layout (out of order, with and without the ``idx`` column, with
the padding row), its edgelist layout (the dense id remap), our npz by
both names (``<root>/<name>.npz``, ``<root>/<dir>/data.npz``, written by
the JAX ``save_npz``), the TGL ``edges.csv`` and ``edges.npz``, and the
missing-dataset errors.  Every array must be exactly equal, dtype
included."""
import dataclasses

import numpy as np
import pytest

from tgb_tgn_dgl_tpu.data import dataset as jd
from tgb_tgn_dgl_tpu_torch.data import dataset as td

FIELDS = [f.name for f in dataclasses.fields(jd.TemporalData)]


def _assert_same(got, want):
    assert [f.name for f in dataclasses.fields(td.TemporalData)] == FIELDS
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


def _both(reader, *args, **kw):
    got = getattr(td, reader)(*args, **kw)
    want = getattr(jd, reader)(*args, **kw)
    _assert_same(got, want)
    return got


def _ml_fixture(d, idx_column: bool, padding_row: bool):
    d.mkdir()
    rows = [(3, 10, 1.0, 1), (4, 11, 2.0, 2), (3, 12, 5.0, 3),
            (5, 10, 4.0, 4), (6, 13, 3.0, 5)]      # out of order in ts
    with open(d / f"ml_{d.name}.csv", "w") as f:
        f.write(",u,i,ts,label" + (",idx" if idx_column else "") + "\n")
        for k, (u, i, ts, idx) in enumerate(rows):
            f.write(f"{k},{u},{i},{ts},0" + (f",{idx}" if idx_column
                                              else "") + "\n")
    n = len(rows) + (1 if padding_row else 0)
    np.save(d / f"ml_{d.name}.npy",
            np.arange(n * 3, dtype=np.float64).reshape(n, 3))


@pytest.mark.parametrize("idx_column,padding_row",
                         [(True, True), (False, True), (False, False)],
                         ids=["idx", "no_idx_padded", "no_idx_unpadded"])
def test_ml_layout_matches_jax(tmp_path, idx_column, padding_row):
    _ml_fixture(tmp_path / "tgbl_fixture", idx_column, padding_row)
    got = _both("load_tgb", "tgbl-fixture", root=str(tmp_path))
    np.testing.assert_array_equal(got.t, [1.0, 2.0, 3.0, 4.0, 5.0])
    assert got.msg.dtype == np.float32 and got.msg.shape == (5, 3)


def test_ml_layout_idx_out_of_range_warns_like_jax(tmp_path):
    d = tmp_path / "tgbl_bad"
    d.mkdir()
    with open(d / "ml_tgbl_bad.csv", "w") as f:
        f.write(",u,i,ts,label,idx\n0,1,2,1.0,0,1\n1,2,3,2.0,0,9\n")
    np.save(d / "ml_tgbl_bad.npy", np.ones((3, 2), np.float32))
    with pytest.warns(UserWarning, match="out of range"):
        got = td.load_tgb("tgbl-bad", root=str(tmp_path))
    with pytest.warns(UserWarning, match="out of range"):
        want = jd.load_tgb("tgbl-bad", root=str(tmp_path))
    _assert_same(got, want)
    assert got.msg.shape == (2, 1)


def test_edgelist_layout_matches_jax(tmp_path):
    d = tmp_path / "tgbl_fix2"
    d.mkdir()
    with open(d / "tgbl-fix2_edgelist_v2.csv", "w") as f:
        f.write("timestamp,src,dst,w0,w1\n")
        f.write("12.0,100,201,0.125,1.125\n")
        f.write("10.0,100,200,0.5,1.5\n")
        f.write("11.0,101,201,0.25,1.25\n")
    got = _both("load_tgb", "tgbl-fix2", root=str(tmp_path))
    assert got.num_nodes == 4


@pytest.mark.parametrize("where", ["name.npz", "dir/data.npz"])
def test_npz_by_name_matches_jax(tmp_path, where):
    """Our canonical npz, written by the JAX ``save_npz``, with fixed
    negatives and a non-default eval metric."""
    E, F, M = 40, 4, 5
    rng = np.random.default_rng(0)
    tr = np.zeros(E, bool)
    tr[:28] = True
    va = np.zeros(E, bool)
    va[28:34] = True
    data = jd.TemporalData(
        name="x", src=rng.integers(0, 10, E).astype(np.int32),
        dst=(10 + rng.integers(0, 10, E)).astype(np.int32),
        t=np.sort(rng.random(E)).astype(np.float32),
        msg=rng.normal(size=(E, F)).astype(np.float32),
        train_mask=tr, val_mask=va, test_mask=~(tr | va),
        val_ns=rng.integers(10, 20, (6, M)).astype(np.int32),
        test_ns=rng.integers(10, 20, (6, M)).astype(np.int32),
        eval_metric="hits@10")
    if where == "name.npz":
        path = tmp_path / "tgbl-custom.npz"
    else:
        (tmp_path / "tgbl_custom").mkdir()
        path = tmp_path / "tgbl_custom" / "data.npz"
    data.save_npz(str(path))
    got = _both("load_tgb", "tgbl-custom", root=str(tmp_path))
    assert got.eval_metric == "hits@10" and got.name == "tgbl-custom"


def test_tgl_csv_matches_jax(tmp_path):
    d = tmp_path / "WIKI"
    d.mkdir()
    with open(d / "edges.csv", "w") as f:
        f.write(",src,dst,time,int_roll,ext_roll\n")
        for k in range(12):
            f.write(f"{k},{k % 5},{5 + k % 3},{float(k * 2)},0,0\n")
    got = _both("load_tgl_data", "WIKI", root=str(tmp_path))
    assert got.num_edges == 12 and got.msg.shape == (12, 1)


def test_tgl_npz_matches_jax(tmp_path):
    d = tmp_path / "REDDIT"
    d.mkdir()
    data = jd.synthetic("tgl", num_edges=60, num_nodes=20, msg_dim=3,
                        num_neg=4, seed=2)
    data.save_npz(str(d / "edges.npz"))
    got = _both("load_tgl_data", "REDDIT", root=str(tmp_path))
    assert got.name == "REDDIT"


@pytest.mark.parametrize("reader,name", [("load_tgb", "tgbl-nope"),
                                         ("load_tgl_data", "NOPE")])
def test_missing_dataset_raises_like_jax(tmp_path, reader, name):
    with pytest.raises(FileNotFoundError) as got:
        getattr(td, reader)(name, root=str(tmp_path))
    with pytest.raises(FileNotFoundError) as want:
        getattr(jd, reader)(name, root=str(tmp_path))
    assert str(got.value) == str(want.value)


def test_processed_directory_without_a_layout_raises(tmp_path):
    """A tgb directory with neither layout: both readers find nothing."""
    (tmp_path / "tgbl_empty").mkdir()
    (tmp_path / "tgbl_empty" / "README.txt").write_text("nothing here")
    assert td._load_tgb_processed(
        "tgbl-empty", str(tmp_path / "tgbl_empty")) is None
    with pytest.raises(FileNotFoundError) as got:
        td.load_tgb("tgbl-empty", root=str(tmp_path))
    with pytest.raises(FileNotFoundError) as want:
        jd.load_tgb("tgbl-empty", root=str(tmp_path))
    assert str(got.value) == str(want.value)
