"""The benchmark of the PyTorch + CUDA port (libsplinter_tpu_torch)."""
