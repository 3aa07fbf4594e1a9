"""The benchmark of ``land_trendr_tpu_torch``, the PyTorch and CUDA port.

``python3 -m lt_bench --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and prints
one JSON line.  Each cell's pieces are files found by name
(:mod:`lt_bench.spec`): a configuration under ``configs/``, a traffic mix
under ``traffic/``, its limits under ``limits/``, one reader per metric
under ``metrics/``.  The scene is made on the card from the seed
(:mod:`lt_bench.gen`), the window drives the port's per-tile step
(:mod:`lt_bench.harness`), and ``correct`` holds what landed against the
plain reference in ``reference/``, which imports nothing of the program.
Nothing here imports JAX or the JAX package.
"""
