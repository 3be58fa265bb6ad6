"""Helpers of the PyTorch port: interop with the JAX package, ragged
bucketing, checkpoints, the hardened RNG, profiling and hex dumps."""
