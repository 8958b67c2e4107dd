"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one command,
``bench/run.py``, driven by the data files beside it."""
