"""Field arithmetic, codecs and the CUDA kernels of the PyTorch port."""
