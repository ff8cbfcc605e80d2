"""Multi-device and multi-host training (the port's counterpart of
tgb_tgn_dgl_tpu/parallel/):

  * the multi-host super-batch engine on one device: multihost.py (the
    exchange protocol, the mail re-plan, the wire composition, the
    composed memory / DyRep steps, and across processes
    ``init_distributed``, ``multihost_allgather``,
    ``make_process_global_wire``), owned_state.py (the node-range-owned
    exchange, ``DistributedOwnerExchange`` across processes) and
    mh_engine.py (``MultiHostEngine``);
  * the sharded engine over a (dp, state) mesh of processes on
    torch.distributed: mesh.py (``Mesh``, ``make_mesh``, the
    collectives), sharded.py (the step's shares and the row-sharded
    memory) and engine.py (``ShardedEngine``).
"""
from .engine import ShardedEngine
from .mesh import Mesh, make_mesh
from .mh_engine import MultiHostEngine

__all__ = ["Mesh", "MultiHostEngine", "ShardedEngine", "make_mesh"]
