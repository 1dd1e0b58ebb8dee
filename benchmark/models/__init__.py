"""The models the benchmark runs, one module a model: models/<name>.py,
named by a configuration's "model" key and found by harness/spec.py::model.

A model module holds everything the harness asks of one model, and the
harness reaches it through nothing else:

  make_splits(config, traffic, seed, device): {"train": (sources, targets),
    "test": (sources, targets) or None}, the traffic's pairs at the model's
    own image side and channels, drawn on the device from `seed`;
  parameter_shapes(config): {network: [(name, shape, init), ...]}, every
    parameter and buffer the program's modules hold, in their order; `init`
    is ("normal", std), drawn by counts/weights.py::draw, or a number to
    fill with; a fourth item names a dtype other than float32;
  reference_train(config, traffic, weights, pairs, seeds, steps, precision):
    the plain reference's first steps: {"losses": [[generator, discriminator]
    a step], "grad_norms": {network: {parameter: the first gradient's
    norm}}, "change_norms": {network: {parameter: the change's norm}}};
  flops_per_image(config): the matrix FLOPs of one train step an image,
    read by metrics/step.mfu.py;
  port_config(cell, seeds): the program's configuration of the cell;
  load_state(state, weights, seeds): the benchmark's weights and seeds into
    the program's state;
  networks(state, config): (name, module, optimizer, first_gradient) of
    each network, first_gradient(parameter's optimizer state) its first
    gradient as the optimizer got it, read after one step with the
    optimizer's constants (beta1) as the configuration states them, never
    as the program holds them;
  losses_of(metrics): [[generator, discriminator]] of each step of a chunk's
    metrics;
  plant_half_batch(): the fault that takes half of each batch
    (faults.py);
  RANGES: the names of the program's ranges that counts/attribution.py
    groups a profile's kernels by.

A model's own per-layer metrics may read more of it (pix2pix's SIDE).
"""
