"""Protocol-level APIs of the PyTorch port (X25519 so far)."""
