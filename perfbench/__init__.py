"""The benchmark of the PyTorch/CUDA port (``mdctgan_tpu_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line.  Everything a cell needs is found by name:
its configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json`` (which names its driver, ``drivers/<driver>.py``)
and each metric's reader in ``metrics/<metric>.py``.  ``reference/`` is the
plain float32 PyTorch reference that decides ``correct``; it imports nothing
of the port.  Nothing here imports JAX or the JAX package.
"""
