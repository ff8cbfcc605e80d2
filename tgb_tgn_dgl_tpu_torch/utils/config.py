"""Config system: the TGL 4-section YAML schema, typed and validated.

The port's copy of tgb_tgn_dgl_tpu/utils/config.py.  It keeps the schema
fields (so the same ``configs/TGN.yml``, ``configs/TGN-memory.yml``,
``configs/TGN-2layer.yml``, ``configs/JODIE.yml`` and ``configs/DyRep.yml``
parse in both packages; the port's ``configs/DyGFormer.yml`` sets the
``gnn`` keys of DyGFormer, which the JAX package does not run,
``PORT_ONLY_GNN_KEYS``) and the train knobs the port reads, among them
the JAX package's two transports that keep stream state on the device,
with its defaults (off): ``train.device_cache`` (the neighbor cache and
clocks on the card, the lean wire; ops/lean_wire.py) and
``train.wire_train_lean`` (train dedup wires without their Δt fields;
ops/wire.py::train_lean_dedup).  The JAX package's other transport and
dispatch knobs (``wire_compact``, ``wire_dedup``, the blob wire, fused
steps, ``eval_slot_unique``, rng_impl, use_pallas) have no counterpart
here: the port always ships the dedup wire, falling back to the compact
wire where a batch needs it, and evaluates by the slot-unique protocol
wherever its structural gate opens (engine/train.py); a config that sets
one of those knobs is refused as an unknown key rather than ignored.

``sampling.strategy`` takes 'recent' (the streaming recency cache) or
'uniform' (K uniform draws from the t-CSR of the whole history, data/
tcsr.py), ``train.compute_dtype`` 'float32' or 'bfloat16' (the embedding's
dense compute, models/tgnn.py), and ``train.remat`` recomputes the
memory-mode embedding in the backward; ``validate`` refuses another
strategy or dtype, and an unknown ``gnn.arch`` raises ValueError
(models/factory.py).  As in the JAX package, ``gnn.layer``,
``sampling.layer`` and ``gnn.message_mode`` are not checked here: the
model refuses a ``gnn.layer`` outside 1..8 and a ``message_mode`` other
than 'scalar' or 'vector' (models/tgnn.py::check_supported), and
``sampling.layer`` is schema only (the packer follows ``gnn.layer``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml


@dataclass
class SamplingConfig:
    layer: int = 1
    neighbor: List[int] = field(default_factory=lambda: [10])
    strategy: str = "recent"          # 'recent' | 'uniform'
    prop_time: bool = False
    history: int = 1
    duration: float = 0.0
    num_thread: int = 32              # host-side packer/sampler threads

    @property
    def num_neighbors(self) -> int:
        return int(self.neighbor[0])


@dataclass
class MemoryConfig:
    type: str = "node"                # 'node' | 'none'
    dim_time: int = 100
    deliver_to: str = "self"
    mail_combine: str = "last"        # 'last' | 'mean'
    memory_update: str = "gru"        # 'gru' | 'rnn'
    mailbox_size: int = 1
    combine_node_feature: bool = True
    dim_out: int = 100
    # DyRep message-field composition (reference
    # modules/memory_module.py:266-267,387-408): use the batch EMBEDDING
    # (instead of memory) for the self / partner field of the stored
    # message.  Reference defaults: both False.  Applies to gnn.arch
    # 'dyrep' (the eager-mail memory, models/variants.py).
    use_src_emb_in_msg: bool = False
    use_dst_emb_in_msg: bool = False

    @property
    def enabled(self) -> bool:
        return self.type == "node"


@dataclass
class GnnConfig:
    arch: str = "transformer_attention"
    layer: int = 1
    att_head: int = 8
    dim_time: int = 100
    dim_out: int = 100
    # 'scalar' reproduces the reference EdgeGATConv message quirk
    # (model_utils.py:560-563: messages are (E, H, 1) scalars); 'vector'
    # is the corrected per-head vector-message attention.
    message_mode: str = "scalar"
    # Reference hardcodes 0.6 ignoring config (model_utils.py:664-666);
    # train.dropout/att_dropout are honored.  Set this to override both.
    override_dropout: Optional[float] = None
    # DyGFormer (gnn.arch 'dygformer', models/dygformer.py): the node
    # feature width (DyGLib pads every stream's features to 172), the
    # channel width C, the tokens a patch and the tokens of an end's
    # sequence L (the end and its L - 1 latest interactions); dim_time is
    # its time encoding's width, layer and att_head its encoder's
    node_feat_dim: int = 172
    channel_embedding_dim: int = 50
    patch_size: int = 1
    max_input_sequence_length: int = 32


# the gnn keys the port has and the JAX package has not: DyGFormer's
PORT_ONLY_GNN_KEYS = ("node_feat_dim", "channel_embedding_dim", "patch_size",
                      "max_input_sequence_length")


@dataclass
class TrainConfig:
    epoch: int = 3000
    batch_size: int = 2000
    lr: float = 1e-4
    dropout: float = 0.2
    att_dropout: float = 0.2
    all_on_gpu: bool = True           # device-resident edge features
    reorder: Optional[int] = None
    seed: int = 0
    # Intra-batch predecessor cap per root slot: the packed in-edge grid
    # is (R, K+1+P), and hub nodes can appear in hundreds of events of one
    # batch.  The default keeps each root's 32 most-recent intra-batch
    # predecessors; None = exact reference semantics (ALL earlier in-batch
    # edges into a root, model_utils.py:151-157).
    max_intra_block: Optional[int] = 32
    # Reference freezes memory at all-ones (model_utils.py:270-271,31).
    frozen_memory: bool = True
    # 'truncate_min' = reference eval-negative handling
    # (epoch_utils.py:48-56); 'pad_mask' = faithful-to-TGB pad+mask.
    eval_neg_mode: str = "truncate_min"
    # Evaluate fixed negatives in chunks of this many per event (exact:
    # MRR ranks are additive across chunks).  None = auto (~24K root
    # slots per chunk, engine/train.eval_neg_chunk_size).
    eval_neg_chunk: Optional[int] = None
    # dtype for the dense compute path: 'float32' | 'bfloat16'
    compute_dtype: str = "float32"
    # Debug short-circuit (reference epoch_utils.py:12-13,188-192): stop
    # each train epoch after N batches.  0 = off.
    sanity_batches: int = 0
    # Recompute the embedding's grid residuals in the backward of the
    # memory-mode step (the JAX package's jax.checkpoint knob; here
    # torch.utils.checkpoint with the dropout generator replayed)
    remat: bool = False
    # The train-lean wire (ops/wire.py::train_lean_dedup): train dedup
    # wires ship the pre-batch clock rows of their unique table and the
    # block ids in place of the three f32 Δt fields, and the device
    # derives every Δt bit-exactly (one scatter-max and one cummax).
    wire_train_lean: bool = False
    # Device-cache mode (ops/lean_wire.py): the recency neighbor cache
    # and the per-node clocks live on the device; the host ships an
    # event-only lean wire.  Taken by TGN (gnn.arch
    # 'transformer_attention') at gnn.layer 1 with the 'recent'
    # strategy, frozen or with the mailbox memory; any other
    # configuration runs the host packer (Engine.device_cache says which).
    device_cache: bool = False


@dataclass
class FrameworkConfig:
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    gnn: GnnConfig = field(default_factory=GnnConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def validate(self) -> "FrameworkConfig":
        """Reject non-default values of schema-only knobs (the reference
        never implemented them either) instead of silently ignoring them."""
        s, m, t = self.sampling, self.memory, self.train
        if s.prop_time:
            raise NotImplementedError(
                "sampling.prop_time is schema-only; only False is supported")
        if s.history != 1:
            raise NotImplementedError(
                "sampling.history is schema-only; only 1 is supported")
        if s.duration != 0.0:
            raise NotImplementedError(
                "sampling.duration is schema-only; only 0.0 is supported")
        if m.deliver_to != "self":
            raise NotImplementedError(
                "memory.deliver_to='neighbors' (TGL mail fan-out) is not "
                "implemented; only 'self' is supported")
        if not m.combine_node_feature:
            raise NotImplementedError(
                "memory.combine_node_feature=False is schema-only; only "
                "True is supported")
        if t.reorder is not None:
            raise NotImplementedError(
                "train.reorder is schema-only; leave it unset")
        if s.strategy not in ("recent", "uniform"):
            raise ValueError(f"sampling.strategy={s.strategy!r}: expected "
                             f"'recent' or 'uniform'")
        if t.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"train.compute_dtype={t.compute_dtype!r}: "
                             f"expected 'float32' or 'bfloat16'")
        return self


def _build(dc_cls, raw: Dict[str, Any]):
    known = {f.name for f in dataclasses.fields(dc_cls)}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(f"Unknown {dc_cls.__name__} keys: {sorted(unknown)}")
    return dc_cls(**raw)


def parse_config(path: str) -> FrameworkConfig:
    """Parse a TGL-schema YAML file (each section is a 1-element list,
    as in reference config/TGN.yml) into a FrameworkConfig."""
    with open(path, "r") as f:
        conf = yaml.safe_load(f)
    return parse_config_dict(conf)


def parse_config_dict(conf: Dict[str, Any]) -> FrameworkConfig:
    def section(name):
        raw = conf.get(name, [{}])
        if isinstance(raw, list):
            raw = raw[0] if raw else {}
        return raw or {}

    return FrameworkConfig(
        sampling=_build(SamplingConfig, section("sampling")),
        memory=_build(MemoryConfig, section("memory")),
        gnn=_build(GnnConfig, section("gnn")),
        train=_build(TrainConfig, section("train")),
    )
