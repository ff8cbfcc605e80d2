"""The plain references, one module per architecture.

A configuration names its reference by its ``reference`` key, as
``bench_cuda/reference/<name>.py``; the harness imports it as
``bench_cuda.reference.<name>`` (``spec.reference``) and reaches the
architecture only through these functions of it.  A module that lacks
one the cell's entry needs is refused before any engine is built.

Every cell (``COMMON``):

* ``model_of(config, msg_dim)``: the reference's sizes of the model, from
  the configuration's file and the stream's edge-feature width;
* ``make_weights(model, seed, device)``: the run's weights from the seed,
  on the device, by the names the program's ``state_dict`` gives them
  (the harness loads them into the program);
* ``layer_context(model)``: the model's sizes in the per-layer metrics'
  context, worked out from ``model`` alone (the harness adds what it
  reads off the program: padded shapes, memory settings, parameter
  count).

``train_epoch`` cells (``BY_ENTRY["train_epoch"]``):

* ``mask_seed(seed)``: the seed of the program's dropout generator, the
  one the reference draws its masks from;
* ``step_record(pack)``: what the reference needs of each of the first
  steps' device pack (for TGN the root slots of the grid its dropout is
  drawn over);
* ``train_steps(stream, model, weights, seed, batch_size, records,
  device, half_batch, still)``: the first ``len(records)`` train steps
  from the weights, with the two planted faults; returns ``losses``,
  ``grads`` (each step's, by leaf) and ``params`` (after the last).

``evaluate`` cells (``BY_ENTRY["evaluate"]``):

* ``train_epoch_state(stream, model, seed, batch_size, epochs, params,
  device)``: the stream state and the model's state (None without one)
  after the set-up's train epochs, which start every val pass;
* ``val_pass(stream, model, params, state, mem, batch_size, device,
  taus)``: the streaming val pass from them; returns ``mrr``,
  ``counts``, ``taus``, ``bounds``, ``mem`` and ``state``;
* ``program_state(ref_mem, like)``: the reference's model state laid out
  as the program's ``like``, to load into the program and to compare.
"""

COMMON = ("model_of", "make_weights", "layer_context")
BY_ENTRY = {"train_epoch": ("mask_seed", "step_record", "train_steps"),
            "evaluate": ("train_epoch_state", "val_pass", "program_state")}
