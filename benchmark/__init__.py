"""The benchmark of the PyTorch and CUDA port (``msau_tpu_torch``): the
harness, the yardstick and the plain reference.  See ``run.py``."""
