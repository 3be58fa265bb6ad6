"""Interop and timing helpers of the PyTorch port."""
