"""Multi-host super-batch training on one device (the port's counterpart
of tgb_tgn_dgl_tpu/parallel/ with ``mesh=None``): multihost.py (the
exchange protocol, the mail re-plan, the wire composition and the composed
memory / DyRep steps), owned_state.py (the node-range-owned exchange) and
mh_engine.py (``MultiHostEngine``)."""
