"""The benchmark of ``deepgraphpose_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json``; everything a cell needs is
found by name under this folder (see ``harness.py``).
"""
