"""The benchmark of ``dabtools_tpu_torch`` on one CUDA card.

``python3 -m rxbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Layout, every
piece found by its name in ``BENCHMARK.json``:

* ``configs/<name>.json``: a deployment (the ensembles on air, the
  capture's rate and centre, one receiver per block);
* ``traffic/<name>.json``: a traffic mix, read by the one generator,
  ``gen/pool.py`` (block size, input rate, SNR, CFO range, pool length,
  set-up and trace lengths);
* ``metrics/<name>.py``: one metric's reader, ``read(record)``;
* ``gen/``: the signal generator, a frozen copy of the port's NumPy
  transmitter chain; ``reference.py``: the plain ETI reference;
  ``drive.py``: the system under test (the only module that imports the
  program); ``trace.py``: the traced run's spans and profiler window;
* ``tests/``: CPU tests, and card tests marked ``gpu``.
"""
