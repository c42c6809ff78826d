"""The benchmark of the PyTorch and CUDA port (``rocalphago_tpu_torch``)."""
