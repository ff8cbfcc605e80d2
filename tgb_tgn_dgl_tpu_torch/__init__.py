"""tgb_tgn_dgl_tpu_torch — the PyTorch/CUDA port of tgb_tgn_dgl_tpu.

A second package beside the JAX one, with the same module layout, so each
module's counterpart is found by path.  It imports torch and numpy, never
JAX and nothing of the JAX package.  Entry points run on CUDA unless the
caller passes ``device="cpu"``; on a CUDA tensor the attention core is
always the hand-written kernel of ``csrc/attention.cu`` (built with nvcc
at first use into ``_build/``), on a CPU tensor its plain torch version.

Layer map:
  data/      dataset, dependency blocking, host batch packer → device
  ops/       time encoding, masked softmax, GRU/RNN cells, attention
             core + CUDA build
  models/    TGNN (scalar mode, one layer), mailbox memory,
             initializers, dropout
  engine/    train/eval loop (frozen or mailbox memory), evaluator,
             negatives
  utils/     TGL-schema config
  bridge.py  JAX parameter pytree ⇄ torch state dict, JAX MemoryState
             → the port's
"""

__version__ = "0.1.0"
