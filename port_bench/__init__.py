"""Benchmark of the PyTorch/CUDA port (``triangulation_in_deformable_scenes_torch``).

``run.py`` runs one cell once; ``BENCHMARK.json`` at the repository's root
lists the cells, their metrics and bounds.
"""
