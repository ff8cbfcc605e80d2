"""The comparison that decides ``correct``: the program's readings from the
timed path against the plain reference's (``bench_cuda/reference``),
each number beside its limit from ``limits/<workload>.json``.

Training (the first three steps of the set-up's first epoch, run by the
window's own ``Engine.train_epoch``):

* ``first_loss_gap``: the relative gap of the first step's loss;
* ``grad_gap_median``: the first gradient as Adam holds it after step 1
  (exp_avg / (1 - β1)), leaf by leaf: the gap between the program's
  norm and the reference's over the larger of the reference's norm of
  that leaf and of the median leaf; the median leaf;
* ``change_gap_median``: the same of each leaf's change over the three
  steps; the median leaf.

The later steps' losses, the worst leaf's gradient and the worst leaf's
change are not compared: Adam's per-element m / sqrt(v) turns rounding
in gradients near nought into steps of the full learning rate, which
moves the later losses and the worst leaf on some seeds by more than a
lower precision does on others.  ``bench_cuda/control.py`` reads them.
A leaf whose reference gradient is nought to rounding (under a thousandth
of the median leaf's: the attention's root projection when every node
feature is the frozen ones, which the row softmax cancels) is left out;
``LEAF_FLOOR`` is the rule.

The val pass (every pass of the window, from the same start: the stream
state after the set-up's train epoch, the reference's weights and the
memory the reference made over that epoch with them):

* ``answers_wrong``: the answers of the window that say the wrong thing:
  each event of the last pass whose rank counts lie outside the ones
  the reference's scores give with every negative's score moved by up to
  ``TAU`` (a near-tie may fall either way in float32, a duplicated
  negative with it), and each pass whose MRR is not the mean of its
  batches' mean reciprocal ranks;
* ``memory_gap``: the memory after the last pass, the largest element
  gap over the reference's largest element;
* ``state_mismatch``: entries of the stream state (cache, clocks before
  and after the pass; last-update times and mail after it) that differ
  from the reference's: an exact comparison.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

LEAF_FLOOR = 1e-3
# an event's answer is right when its counts lie within what the
# reference's scores give with every negative moved by up to TAU times
# max(1, |positive score|); the rounding of a pass's float32 MRR
TAU = 1e-4
MRR_ROUNDING = 1e-6


def _norms(tensors: Dict[str, torch.Tensor], leaves) -> Dict[str, float]:
    return {k: float(tensors[k].double().norm()) for k in leaves}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms, over the larger of the reference's norm
    of that leaf and of the median leaf."""
    if not leaves:
        return {}
    rp, rr = _norms(prog, leaves), _norms(ref, leaves)
    med = float(np.median(list(rr.values())))
    return {k: abs(rp[k] - rr[k]) / max(rr[k], med, 1e-30) for k in leaves}


def counted_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is above ``LEAF_FLOOR`` times
    the median leaf's."""
    n = _norms(grads, list(grads))
    med = float(np.median(list(n.values())))
    return [k for k in grads if n[k] >= LEAF_FLOOR * med]


def moved_leaves(ref) -> List[str]:
    """The leaves whose reference gradient is above ``LEAF_FLOOR`` times
    the median leaf's at some step."""
    peak = {k: max(float(g[k].norm()) for g in ref.grads)
            for k in ref.grads[0]}
    med = float(np.median(list(peak.values())))
    return [k for k in peak if peak[k] >= LEAF_FLOOR * med]


def train_numbers(prog: dict, ref, weights: Dict[str, torch.Tensor]
                  ) -> Dict[str, float]:
    """``prog``: the program's ``losses``, ``g1`` (first gradient by
    leaf) and ``params`` (after the steps), on the host; ``ref``: the
    reference's ``TrainResult``; ``weights``: the start of both."""
    loss = abs(float(prog["losses"][0]) - ref.losses[0]) / abs(ref.losses[0])
    g_ref = {k: v.cpu() for k, v in ref.grads[0].items()}
    grad = leaf_gaps(prog["g1"], g_ref, counted_leaves(g_ref))
    return {"first_loss_gap": loss,
            "grad_gap_median": float(np.median(list(grad.values()))),
            "change_gap_median": float(np.median(list(
                change_gaps(prog, ref, weights).values())))}


def change_gaps(prog: dict, ref, weights) -> Dict[str, float]:
    """Each moved leaf's gap of the norms of its change over the steps."""
    moved = moved_leaves(ref)
    cpu = {k: weights[k].detach().cpu() for k in moved}
    return leaf_gaps({k: prog["params"][k] - cpu[k] for k in moved},
                     {k: ref.params[k].cpu() - cpu[k] for k in moved},
                     moved)


def val_numbers(prog: dict, ref, start_state) -> Dict[str, float]:
    """``prog``: the program's ``mrrs`` (one a pass), ``counts`` (per
    pass, its events' better and at-least-as-good counts and each
    event's batch), its stream state before (``packer_before``) and after
    (``packer_after``) the last pass, and its memory after it
    (``mem_after``, the port's MemoryState on the host, or None);
    ``ref``: the reference's ``ValResult`` with ``TAU`` among its slacks;
    ``start_state``: the reference's stream state before the pass."""
    mis = _state_mismatch(prog["packer_before"], start_state)
    mis += _state_mismatch(prog["packer_after"], ref.state)
    mem_gap = 0.0
    if ref.mem is not None:
        pm, rm = prog["mem_after"], ref.mem
        n = rm.mem.shape[0]            # the port has a trash row past it
        ref_mem = rm.mem.cpu()
        mem_gap = float((pm.mem[:n] - ref_mem).abs().max()
                        / ref_mem.abs().max().clamp_min(1e-30))
        mis += _mail_mismatch(pm, rm, n)
    opt, pes, _ = prog["counts"][-1]
    outside = rank_outside(opt, pes, ref.bounds)[ref.taus.index(TAU)]
    return {"answers_wrong": float(outside + mrr_inconsistent(prog)),
            "memory_gap": mem_gap, "state_mismatch": float(mis)}


def rank_outside(opt, pes, bounds) -> List[int]:
    """Per slack of the reference's bounds, the events whose counts lie
    outside them."""
    opt, pes = np.asarray(opt)[:, None], np.asarray(pes)[:, None]
    ok = ((bounds[:, :, 0] <= opt) & (opt <= bounds[:, :, 2])
          & (bounds[:, :, 1] <= pes) & (pes <= bounds[:, :, 3]))
    return [int(n) for n in (~ok).sum(axis=0)]


def mrr_inconsistent(prog) -> int:
    """Passes whose MRR is not the mean of its batches' mean reciprocal
    rank, from the pass's own counts (to float32 rounding)."""
    bad = 0
    for mrr, (opt, pes, blk) in zip(prog["mrrs"], prog["counts"]):
        recip = 1.0 / (0.5 * (opt + pes) + 1.0)
        sums = np.bincount(blk, weights=recip)
        means = sums / np.bincount(blk)
        bad += abs(float(means.mean()) - mrr) > MRR_ROUNDING
    return bad


def _state_mismatch(packer_snapshot, state) -> int:
    nbr, eid, t, clock = packer_snapshot[:4]
    ok = state.eid >= 0
    return int((eid != state.eid).sum()
               + (nbr[ok] != state.nbr[ok]).sum()
               + (t[ok] != state.t[ok]).sum()
               + (clock != state.clock).sum())


def _mail_mismatch(pm, rm, n: int) -> int:
    """Last-update times and the mail of every node, exactly."""
    valid = pm.mail_valid[:n, 0]
    rv = rm.mail_valid[:n].cpu()
    both = valid & rv
    nodes = torch.arange(n)
    return int((pm.last_update[:n] != rm.last_update[:n].cpu()).sum()
               + (valid != rv).sum()
               + (pm.mail_src[:n, 0][both] != nodes[both]).sum()
               + (pm.mail_dst[:n, 0][both].long()
                  != rm.mail_dst[:n].cpu()[both]).sum()
               + (pm.mail_t[:n, 0][both] != rm.mail_t[:n].cpu()[both]).sum()
               + (pm.mail_eid[:n, 0][both].long()
                  != rm.mail_eid[:n].cpu()[both]).sum())


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> dict:
    """Each number that ``limits`` (the cell's limits file) names, beside
    its limit: ok when at or under it.  A number the run could not read
    fails."""
    out = {}
    for name, lim in limits.items():
        value = numbers.get(name)
        limit = float(lim["limit"])
        out[name] = {"value": None if value is None else float(value),
                     "limit": limit,
                     "ok": value is not None and float(value) <= limit}
    return out
