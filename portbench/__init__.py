"""The benchmark of the PyTorch/CUDA port (``apex_tpu_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line.  Everything a cell needs is found by name:
its configuration under ``configs/`` (with its FLOP count beside it), its
configuration's learner family under ``families/``, its traffic mix under
``traffic/``, the traffic's pool under ``pools/``, the limits of its
``correct`` under ``limits/`` and each per-layer metric's reader under
``metrics/``.  ``reference/`` is the plain PyTorch and NumPy reference
that decides ``correct``.
"""
