"""The benchmark of the PyTorch and CUDA port (``next3d_tpu_torch``): see
``run.py`` and ``BENCHMARK.json``."""
