"""One module per application of the program that a configuration names
(``"app"``). Each gives the harness:

* ``make_data(config, seed, device)``: the benchmark's own inputs, made
  on the device from the seed and handed to the host as the program's
  data types take them;
* ``experiment(settings, data, device)``: the program's experiment with
  the benchmark's data put in through its one loading hook;
* ``weight_shapes(config)`` and ``fixed_weights(config, data)``: the
  three models' weights, by the program's parameter names;
* ``checked_batches(exp, data, rng, steps)``: each checked step's batch
  through the program's own input call, with what the reference needs to
  work it out again;
* ``reference_batch(config, data, record, device)``: that batch worked
  out by the reference;
* ``batch_shapes(config, batch)``: a step's batch shapes, for the counts;
* ``reference_models(config)``: the reference's models and labeled loss.
"""
