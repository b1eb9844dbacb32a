"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything a cell
needs is found by name: its configuration in ``configs/<name>.json``,
its traffic mix in ``traffic/<name>.json``, its correctness limit in
``limits/<cell>.json`` and each per-layer metric in
``metrics/<name>.py``.
"""
