"""DyGFormer on the port (``gnn.arch: dygformer``, models/dygformer.py)
against its plain reference (baselines/dygformer_reference.py), on the
CPU at a small size: the packer's per-event histories, the co-occurrence
counts, the forward logits (patch size 1 and 2), the first three train
steps through ``Engine.train_epoch``, the streaming val pass, the CLI,
the gates and the parallel engines' refusals."""
import numpy as np
import pytest
import torch

from baselines import dygformer_reference as ref
from tgb_tgn_dgl_tpu_torch.data.dataset import synthetic
from tgb_tgn_dgl_tpu_torch.data.native_packer import NativeStreamPacker
from tgb_tgn_dgl_tpu_torch.data.packer import PackerConfig
from tgb_tgn_dgl_tpu_torch.engine.train import Engine
from tgb_tgn_dgl_tpu_torch.models import dygformer
from tgb_tgn_dgl_tpu_torch.utils.config import parse_config_dict

B = 64


@pytest.fixture(scope="module")
def data():
    return synthetic("tiny", num_edges=600, num_nodes=60, msg_dim=8,
                     num_neg=4, seed=3)


def _conf(L=8, patch=1, drop=0.1, sanity=3, chunk=None, **train):
    return {"memory": [{"type": "none"}],
            "gnn": [{"arch": "dygformer", "layer": 2, "att_head": 2,
                     "dim_time": 12, "node_feat_dim": 10,
                     "channel_embedding_dim": 8, "patch_size": patch,
                     "max_input_sequence_length": L}],
            "train": [{"batch_size": B, "lr": 1e-3, "dropout": drop,
                       "att_dropout": drop, "sanity_batches": sanity,
                       "eval_neg_chunk": chunk, "seed": 7, **train}]}


def _engine(data, **kw):
    torch.manual_seed(0)
    conf = _conf(**kw)
    eng = Engine(data, parse_config_dict(conf), device="cpu")
    m = ref.model_of({"tgl": conf}, data.msg_dim)
    weights = ref.make_weights(m, 5, torch.device("cpu"))
    eng.model.load_state_dict(weights)
    return eng, m, weights


@pytest.mark.parametrize("L", [2, 8, 17, 32])
def test_history_pack_follows_the_reference_rule(data, L):
    """Each end's K latest interactions earlier in the stream, batch
    predecessors and negatives included, exactly; a pack that does not
    insert leaves the cache as it was; padding rows are empty.  K runs
    from a one-entry ring to the published 31."""
    packer = NativeStreamPacker(data.num_nodes, PackerConfig(
        num_neighbors=L - 1, batch_size=B))
    hist = ref.Histories(data.num_nodes)
    rng = np.random.default_rng(L)
    rows = np.arange(data.num_edges)
    longest = 0
    for lo in range(0, len(rows), B):
        r = rows[lo:lo + B]
        n = len(r)
        neg = rng.integers(0, data.num_nodes, (n, 3))
        neg[:, 0] = data.dst[r]                    # a negative that is dst
        args = (data.src[r], data.dst[r], data.t[r], r, None, neg)
        before = packer.snapshot()
        dry, _ = packer.pack_history(*args, insert=False)
        for a, b in zip(before, packer.snapshot()):
            assert np.array_equal(a, b)
        wire, _ = packer.pack_history(*args)
        for f in wire._fields:
            assert np.array_equal(getattr(dry, f), getattr(wire, f)), f
        ids, eid, dt, ok = ref.batch_sequences(
            hist, data.src[r], data.dst[r], data.t[r], r, neg, L)
        assert np.array_equal(wire.ev_end[:n], ids[..., 0])
        assert np.array_equal(wire.hist_len[:n], ok.sum(-1) - 1)
        held = ok[..., 1:]
        assert np.array_equal(wire.hist_nid[:n], np.where(held,
                                                          ids[..., 1:], -1))
        assert np.array_equal(wire.hist_eid[:n], np.where(held,
                                                          eid[..., 1:], -1))
        assert np.array_equal(wire.hist_dt[:n], dt[..., 1:])
        assert wire.ev_valid[:n].all() and not wire.ev_valid[n:].any()
        assert (wire.hist_len[n:] == 0).all()
        longest = max(longest, int(wire.hist_len.max()))
    assert longest == L - 1                        # hubs past the cap


def test_cooccurrence_counts_by_hand():
    """Repeats, padding, a node in both sequences; the port's counts and
    the reference's."""
    a = torch.tensor([[4, 9, 4, 4, -1, -1]])
    a_ok = torch.tensor([[True, True, True, True, False, False]])
    b = torch.tensor([[9, 2, 9, -1, -1, -1]])
    b_ok = torch.tensor([[True, True, True, False, False, False]])
    want_a = [[3, 0], [1, 2], [3, 0], [3, 0], [0, 0], [0, 0]]
    want_b = [[2, 1], [1, 0], [2, 1], [0, 0], [0, 0], [0, 0]]
    for fn in (dygformer.cooccurrence_counts, ref.cooccurrence):
        assert fn(a, a_ok, b, b_ok)[0].tolist() == want_a
        assert fn(b, b_ok, a, a_ok)[0].tolist() == want_b
    # padding ids never count, even where they equal a real id
    pad = torch.tensor([[4, 4]])
    assert fn(pad, torch.tensor([[True, False]]), pad,
              torch.tensor([[False, True]]))[0].tolist() == [[1, 1], [0, 0]]


@pytest.mark.parametrize("patch", [1, 2])
def test_forward_logits_match_the_reference(data, patch):
    eng, m, weights = _engine(data, patch=patch)
    rows = np.arange(B)
    neg = np.random.default_rng(0).integers(0, data.num_nodes, (B, 2))
    hist = ref.train_histories(data, 200)
    eng.packer.restore(_packer_after(data, 200, m.L))
    r = rows + 200
    args = (data.src[r], data.dst[r], data.t[r], r, None, neg)
    wire, _ = eng.packer.pack_history(*args, insert=False)
    from tgb_tgn_dgl_tpu_torch.ops.wire import wire_to_device
    with torch.no_grad():
        pos, negl = eng._score_pairs(wire_to_device(wire, "cpu"),
                                     train=False)
        seqs = ref.sequences_on(ref.batch_sequences(
            hist, *args[:4], neg, m.L), "cpu")
        want = ref.pair_logits(weights, m, seqs,
                               torch.as_tensor(data.msg)).reshape(3, B).t()
    got = torch.cat([pos[:, None], negl], dim=1)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * want.abs().max())


def _packer_after(data, n_events, L):
    p = NativeStreamPacker(data.num_nodes, PackerConfig(
        num_neighbors=L - 1, batch_size=B))
    r = np.arange(n_events)
    p.insert(data.src[r], data.dst[r], data.t[r], e_id=r)
    return p.snapshot()


def test_train_steps_in_lockstep_with_the_reference(data):
    """Three Adam steps through Engine.train_epoch, dropout on, against the
    reference from the same weights, negatives and masks: each step's
    loss, the first gradient and the parameters after three steps."""
    eng, m, weights = _engine(data)
    eng.generator.manual_seed(ref.mask_seed(7))
    seen = []
    orig = eng._train_step

    def step(pack, acc):
        seen.append(ref.step_record(pack))
        out = orig(pack, acc)
        if len(seen) == 1:
            st = eng.optimizer.state
            seen.append({k: st[p]["exp_avg"] / 0.1 if p in st else p * 0
                         for k, p in eng.model.named_parameters()})
        seen.append(float(out[0]))
        return out
    eng._train_step = step
    eng.train_epoch()
    records = [seen[0], seen[3], seen[5]]
    losses = [seen[2], seen[4], seen[6]]
    r = ref.train_steps(data, m, weights, 7, B, records, "cpu")
    assert records == [B, B, B]
    assert np.allclose(losses, r.losses, rtol=1e-5)
    for k, g in r.grads[0].items():
        assert torch.allclose(seen[1][k], g, rtol=1e-4,
                              atol=1e-5 * float(g.abs().max()) + 1e-9), k
    for k, v in eng.model.named_parameters():
        moved = (r.params[k] - weights[k]).norm()
        assert float((v.detach() - r.params[k]).norm()) <= 1e-3 * float(
            moved) + 1e-7, k


def test_evaluate_mrr_equals_the_reference(data):
    """The streaming val pass at M = 4 by column chunks of 2 (the first
    chunk packs without inserting) after three train batches."""
    eng, m, weights = _engine(data, chunk=2)
    eng.train_epoch()
    params = {k: v.detach() for k, v in eng.model.state_dict().items()}
    mrr = eng.evaluate("val")
    assert eng.last_eval_trace["protocol"] == "column_chunk"
    hist = ref.train_histories(data, 3 * B)
    want = ref.val_pass(data, m, params, hist, data.val_ns, B, "cpu")
    assert abs(mrr - want) < 1e-6
    assert eng.packer.cur_e_id == int(np.nonzero(data.val_mask)[0][-1]) + 1


def test_epoch_trace_counts_pairs_and_history(data):
    eng, _, _ = _engine(data, sanity=0)
    eng.train_epoch()
    tr = eng.last_epoch_trace
    n_train = int(data.train_mask.sum())
    steps = -(-n_train // B)
    assert tr["batches"] == steps and tr["pairs"] == 2 * B * steps
    assert 0.0 < tr["history_filled"] <= 1.0
    for name in ("step.embed.pairs", "step.embed.encoder", "step.embed"):
        assert tr["spans"][name]["n"] >= steps


def test_gates_and_refusals(data, capsys):
    """Device-cache mode and the slot-unique eval are off, each saying
    why; the parallel engines refuse the arch; a memory is refused."""
    from tgb_tgn_dgl_tpu_torch.parallel.engine import check_sharded
    from tgb_tgn_dgl_tpu_torch.parallel.mh_engine import MultiHostEngine
    eng, _, _ = _engine(data, device_cache=True, sanity=1)
    assert not eng.device_cache
    eng.train_epoch()
    eng.evaluate("val")
    out = capsys.readouterr().out
    assert "device-cache mode off" in out
    assert "slot-unique protocol off (gnn.arch dygformer scores pairs)" in out
    cfg = parse_config_dict(_conf())
    with pytest.raises(ValueError, match="dygformer"):
        check_sharded(cfg, 1)
    with pytest.raises(ValueError, match="dygformer"):
        MultiHostEngine(data, cfg, n_hosts=2, device="cpu")
    conf = _conf()
    conf["memory"] = [{"type": "node"}]
    conf["train"][0]["frozen_memory"] = False
    with pytest.raises(ValueError, match="no memory"):
        Engine(data, parse_config_dict(conf), device="cpu")


def test_published_config_parses_at_its_widths(data):
    from tgb_tgn_dgl_tpu_torch.utils.config import parse_config
    from tgb_tgn_dgl_tpu_torch.utils.flops import count_params
    cfg = parse_config("tgb_tgn_dgl_tpu_torch/configs/DyGFormer.yml")
    wiki = synthetic("tiny", num_edges=50, num_nodes=20, msg_dim=172)
    eng = Engine(wiki, cfg, device="cpu")
    assert eng.pairs and not eng.use_memory
    assert eng.packer.cfg.num_neighbors == 31
    assert count_params(eng.model) == 1_087_035


def test_cli_trains_checkpoints_and_resumes(data, tmp_path):
    """``run_tgn`` with a DyGFormer config: fit, a val pass, a checkpoint;
    a run resumed from it trains its second epoch as the whole run did."""
    import yaml
    from tgb_tgn_dgl_tpu_torch.run_tgn import main
    (tmp_path / "ds").mkdir()
    data.save_npz(str(tmp_path / "ds" / "tiny.npz"))
    conf = _conf(sanity=2)
    (tmp_path / "dyg.yml").write_text(yaml.safe_dump(conf))

    def run(log, *extra):
        return main(["--data", "tiny", "--root", str(tmp_path / "ds"),
                     "--config", str(tmp_path / "dyg.yml"), "--device",
                     "cpu", "--log-dir", str(tmp_path / log), *extra])
    whole = run("a", "--epochs", "2", "--checkpoint-every", "1")
    rest = run("b", "--epochs", "2", "--resume",
               str(tmp_path / "a" / "ckpt_epoch0001.pt"))
    assert len(whole["histories"][0]["val"]) == 2
    assert rest["histories"][0]["loss"] == whole["histories"][0]["loss"][1:]
    assert rest["histories"][0]["val"] == whole["histories"][0]["val"][1:]
