"""Moving byte and limb tensors between the JAX package and the port.

Both packages use the same layouts: ``[..., 32]`` uint8 byte strings and
``[..., 20]`` int32 limbs. State crosses as numpy arrays (``np.asarray`` of a
JAX array on one side); the dtype is kept, so equal arrays mean equal bytes
or equal limbs.
"""

import numpy as np
import torch

__all__ = ["from_numpy", "to_numpy"]

_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32}


def from_numpy(arr, device="cpu"):
    """A uint8 or int32 numpy array (or anything np.asarray accepts, such as
    a JAX array) as a torch tensor of the same dtype on `device`."""
    arr = np.asarray(arr)
    if arr.dtype not in _DTYPES:
        raise TypeError("expected uint8 bytes or int32 limbs, got %s"
                        % arr.dtype)
    # np.array copies: the tensor never shares a (possibly read-only) buffer
    return torch.from_numpy(np.array(arr)).to(device)


def to_numpy(t):
    """A torch tensor (any device) as a numpy array of the same dtype."""
    return t.detach().cpu().numpy()
