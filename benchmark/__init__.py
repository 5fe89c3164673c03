"""The benchmark of ``montage_gan_tpu_torch`` on NVIDIA H100 cards.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything a cell needs is data found by name: the configuration in
``configs/<config>.json``, the traffic in ``traffic/<traffic>.json``, each
per-layer metric's reader in ``metrics/<metric>.py``.  The yardstick (the
synthetic data, the seeded weights and draws, the FLOP arithmetic, the
trace reduction, the plain reference in ``reference/`` and the comparison
that decides ``correct``) lives here and imports nothing of JAX.
"""
