"""The benchmark of the PyTorch and CUDA port (``kubeflow_rm_tpu_torch``).

``BENCHMARK.json`` at the repository's root names the cells; ``run.py``
runs one and prints its result line. Everything a cell needs is a file
found by name: its configuration (``configs/``), traffic mix
(``traffic/``, naming a driver in ``drivers/``), correctness limits
(``limits/``) and per-layer metric readers (``metrics/``). ``reference/``
is the plain float32 model the program is held to; it imports nothing of
the program.
"""
