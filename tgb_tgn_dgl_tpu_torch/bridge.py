"""Weight bridge between the JAX package's parameter pytree and the port's
``state_dict``, both ways, through numpy.

The JAX tree is nested dicts of arrays (``models/tgnn.py::init_tgnn``
there).  A linear layer is a dict ``{"w": (in, out), "b": (out,)}``; the
port holds it as ``nn.Linear`` with ``weight`` (out, in), so the bridge
transposes.  Every other leaf keeps its shape and name (the time
encoding's vector ``{"w", "b"}`` stays ``time.w``, ``time.b``).  Keys join with ``.``:
``{"gat": {"fc_node": {"w", "b"}, "attn_l"}}`` ⇄ ``gat.fc_node.weight``,
``gat.fc_node.bias``, ``gat.attn_l``.  The mailbox memory's subtree
``{"memory": {"time": {"w", "b"}, "cell": {"w_ih", "w_hh", "b_ih",
"b_hh"}}}`` keeps its layout (the port's cells multiply from the right, as
the JAX cells do): ``memory.time.w``, ``memory.cell.w_ih`` and so on.

JODIE's time projection ``{"jodie": {"w": (1, D), "b": (D,)}}`` is a
linear's dict and becomes ``jodie.weight`` (D, 1), ``jodie.bias``, as the
port holds it (``models/variants.TimeEmbedding``, an ``nn.Linear(1, D)``).
DyRep's eager memory subtree ``{"memory": {"cell": {...}}}`` becomes
``memory.cell.*``.  The decoders' leaves follow the same rules: ConvTransE's
``conv_w`` (C, 2, ks) keeps its layout, ``fc`` is a linear and the batch
norms' ``bnX.{scale,bias}`` are vectors; their running statistics are
state, not parameters (``conv_transe_state_from_jax``).

``memory_state_from_jax`` and ``eager_memory_state_from_jax`` turn the
JAX package's ``MemoryState`` / ``EagerMemoryState`` into the port's,
through numpy.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .models.memory import MemoryState
from .models.variants import EagerMemoryState


def _is_linear(node) -> bool:
    """A linear layer's dict; the time encoding's {"w", "b"} are vectors."""
    return (isinstance(node, Mapping) and set(node) <= {"w", "b"}
            and "w" in node and np.ndim(node["w"]) == 2)


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter pytree (arrays convertible with ``np.asarray``) ->
    the port's state dict of float32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if _is_linear(node):
            out[prefix + "weight"] = torch.from_numpy(
                np.array(np.asarray(node["w"], np.float32).T, order="C"))
            if "b" in node:
                out[prefix + "bias"] = torch.from_numpy(
                    np.array(node["b"], np.float32))
        elif isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        else:
            out[prefix[:-1]] = torch.from_numpy(np.array(node, np.float32))

    walk(tree, "")
    return out


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict:
    """The port's state dict (or any name -> tensor map with the same
    names, e.g. gradients) -> nested dict of numpy arrays in the JAX
    layout.  A ``bias`` is a linear's ``b`` beside its ``weight``, and
    keeps its name elsewhere (a batch norm's ``{"scale", "bias"}``)."""
    tree: Dict = {}
    for name, t in state.items():
        a = t.detach().cpu().numpy()
        *path, leaf = name.split(".")
        if leaf == "weight":
            leaf, a = "w", np.ascontiguousarray(a.T)
        elif leaf == "bias" and ".".join(path + ["weight"]) in state:
            leaf = "b"
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def memory_state_from_jax(state) -> MemoryState:
    """The JAX ``MemoryState`` -> the port's ``MemoryState`` of CPU
    tensors, field by field (both use float32, int32 and bool)."""
    return MemoryState(**{f: torch.from_numpy(np.array(getattr(state, f)))
                          for f in MemoryState._fields})


def eager_memory_state_from_jax(state) -> EagerMemoryState:
    """The JAX ``EagerMemoryState`` (DyRep) -> the port's, field by
    field."""
    return EagerMemoryState(**{
        f: torch.from_numpy(np.array(getattr(state, f)))
        for f in EagerMemoryState._fields})


def conv_transe_state_from_jax(state) -> Dict[str, torch.Tensor]:
    """The JAX ``ConvTransEState`` (three ``BNState``s) -> the running
    statistics of the port's ``ConvTransE`` by buffer name
    (``bn0.mean``, ``bn0.var``, …), to load with its parameters."""
    return {f"{bn}.{stat}": torch.from_numpy(
                np.array(getattr(getattr(state, bn), stat), np.float32))
            for bn in ("bn0", "bn1", "bn2") for stat in ("mean", "var")}
