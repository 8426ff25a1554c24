"""The benchmark of the PyTorch and CUDA port (``ital_tpu_torch``): see README.md."""
