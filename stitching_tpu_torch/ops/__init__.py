"""Array ops of the PyTorch port; the CUDA kernels live in `kernels/`."""
