"""Checkpoint / resume and early stopping: the port's counterpart of
tgb_tgn_dgl_tpu/engine/checkpoint.py.

A checkpoint is one file written by ``torch.save`` and read back with
``torch.load(..., weights_only=True)``: a nested dict whose leaves are
tensors, ints, floats, strings, and the lists, tuples, bools and None of
an optimizer's ``param_groups`` (the packer's shape buckets are keyed by
(M, eval_mode) tuples).  The Engine converts what is not (the packer's
numpy arrays, the numpy PCG64 generator, the memory's NamedTuple) on the
way in and out (engine/train.py::Engine._full_state).  The restoring side
supplies a template of the state it expects: a key that the file lacks,
or a tensor whose shape differs, raises and names the key, as the JAX
package's ``load_pytree`` does.

``EarlyStopMonitor`` is the reference's patience monitor
(modules/early_stopping.py:10-89) with the JAX package's semantics: an
improvement is a relative gain over the best value beyond ``tolerance``,
and training stops after ``max_round`` validations without one.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

CHECKPOINT_SUFFIX = ".pt"


def save_state(path: str, tree) -> None:
    torch.save(tree, path)


def _check(tree, template, path: str = "") -> None:
    """Every key of ``template`` is in ``tree``, nested dicts alike, and
    every tensor of ``template`` has its shape there."""
    for k, want in template.items():
        key = f"{path}/{k}" if path else str(k)
        if not isinstance(tree, dict) or k not in tree:
            raise KeyError(f"checkpoint missing leaf '{key}'")
        got = tree[k]
        if isinstance(want, dict):
            _check(got, want, key)
        elif isinstance(want, torch.Tensor) and (
                not isinstance(got, torch.Tensor) or got.shape != want.shape):
            shape = getattr(got, "shape", type(got).__name__)
            raise ValueError(
                f"shape mismatch for '{key}': ckpt {tuple(shape)} vs "
                f"template {tuple(want.shape)}")


def load_state(path: str, template, device="cpu"):
    """Read a ``save_state`` file onto ``device`` and hold it against
    ``template``: every key of the template must be in the file, and
    every tensor leaf must have the template's shape."""
    tree = torch.load(path, weights_only=True, map_location=device)
    _check(tree, template)
    return tree


def rng_state_to_array(rng: np.random.Generator) -> np.ndarray:
    """Serialize a numpy PCG64 Generator state to a plain uint64 array
    (state/inc are 128-bit → hi/lo pairs, plus the uint32 cache)."""
    s = rng.bit_generator.state
    assert s["bit_generator"] == "PCG64", s["bit_generator"]
    st, inc = s["state"]["state"], s["state"]["inc"]
    mask = (1 << 64) - 1
    return np.array([st >> 64, st & mask, inc >> 64, inc & mask,
                     s["has_uint32"], s["uinteger"]], dtype=np.uint64)


def rng_state_from_array(a: np.ndarray) -> np.random.Generator:
    a = [int(x) for x in np.asarray(a, np.uint64)]
    rng = np.random.default_rng(0)
    rng.bit_generator.state = {
        "bit_generator": "PCG64",
        "state": {"state": (a[0] << 64) | a[1], "inc": (a[2] << 64) | a[3]},
        "has_uint32": a[4],
        "uinteger": a[5],
    }
    return rng


class EarlyStopMonitor:
    """Patience-based early stopping (reference
    modules/early_stopping.py:10-63 semantics): improvement = relative
    gain over the best seen so far beyond `tolerance`; stop after
    `max_round` consecutive non-improvements."""

    def __init__(self, max_round: int = 5, higher_better: bool = True,
                 tolerance: float = 1e-10, save_dir: Optional[str] = None,
                 name: str = "model"):
        self.max_round = max_round
        self.higher_better = higher_better
        self.tolerance = tolerance
        self.save_dir = save_dir
        self.name = name
        self.num_round = 0
        self.epoch_count = 0
        self.best_epoch = 0
        self.last_best: Optional[float] = None

    @property
    def best_path(self) -> Optional[str]:
        if self.save_dir is None:
            return None
        return os.path.join(self.save_dir,
                            f"{self.name}_best{CHECKPOINT_SUFFIX}")

    def step_check(self, curr_val: float, state=None) -> bool:
        """Returns True when training should STOP.  If `state` is given
        and this epoch is the best so far, it is checkpointed."""
        val = curr_val if self.higher_better else -curr_val
        improved = (self.last_best is None
                    or (val - self.last_best) / abs(self.last_best
                                                    if self.last_best
                                                    else 1.0)
                    > self.tolerance)
        self.epoch_count += 1
        if improved:
            self.last_best = val
            self.num_round = 0
            self.best_epoch = self.epoch_count
            if state is not None and self.best_path is not None:
                os.makedirs(self.save_dir, exist_ok=True)
                save_state(self.best_path, state)
        else:
            self.num_round += 1
        return self.num_round >= self.max_round

    def load_best(self, template, device="cpu"):
        assert self.best_path and os.path.exists(self.best_path), \
            "no best checkpoint saved"
        return load_state(self.best_path, template, device)
