"""The benchmark of the PyTorch and CUDA port (``videoloop3d_torch``);
see ``README.md``."""
