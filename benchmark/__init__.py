"""The benchmark of the PyTorch/CUDA port (``radian_tpu_torch``)."""
