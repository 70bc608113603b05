"""The benchmark of the PyTorch/CUDA port (``hikari_tpu_torch``).

One run trains one cell of ``BENCHMARK.json`` on the CUDA card
for a fixed window and prints one JSON line:

    python -m hikari_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<cell>.json`` and
``metrics/<metric>.py``; a configuration whose scene the reference's
``io/scenes.py`` lacks names the module of the reference's constructor
under ``reference_scene`` (``scenes.build``). The yardstick lives here
too: the ray accounting, the rate, the roofline's bytes and the idle
share (``arith.py``), the reduction of the profiler's events
(``profiling.py``), the comparison that decides ``correct``
(``check.py``) and its plain reference (``reference/``). Nothing here
imports ``jax`` or the JAX package, and the reference imports nothing of
the port.
"""
