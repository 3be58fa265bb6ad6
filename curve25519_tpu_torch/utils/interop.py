"""Moving byte and limb tensors between the JAX package and the port.

Both packages use the same layouts: ``[..., 32]`` uint8 byte strings and
``[..., 20]`` int32 limbs; a blinding context is the same dict of them, and
a verify context the same dict of pk bytes, int8 q_table planes and bool ok
flags.
State crosses as numpy arrays (``np.asarray`` of a JAX array on one side);
the dtype is kept, so equal arrays mean equal bytes or equal limbs. The
tensors land on ``device=`` or, by the device rule of every entry point
(``ops/cuda/__init__.py``), on the CUDA card, and with no card the call
raises; ``device="cpu"`` asks for the CPU.
"""

import numpy as np
import torch

from curve25519_tpu_torch.ops.cuda import pick_device

__all__ = ["from_numpy", "to_numpy", "blinding_from_jax",
           "verify_ctx_from_jax"]

_DTYPES = (np.uint8, np.int32, np.int8, np.bool_)


def from_numpy(arr, device=None):
    """A uint8, int32, int8 or bool numpy array (or anything np.asarray
    accepts, such as a JAX array) as a torch tensor of the same dtype on
    `device` (default: the card)."""
    arr = np.asarray(arr)
    if arr.dtype not in _DTYPES:
        raise TypeError("expected uint8 bytes, int32 limbs, int8 planes or "
                        "bool flags, got %s" % arr.dtype)
    # np.array copies: the tensor never shares a (possibly read-only) buffer
    return torch.from_numpy(np.array(arr)).to(pick_device(device=device))


def to_numpy(t):
    """A torch tensor (any device) as a numpy array of the same dtype."""
    return t.detach().cpu().numpy()


def blinding_from_jax(ctx, device=None):
    """A blinding context of the JAX package (curve25519_tpu.models.blinding,
    its arrays as numpy or JAX arrays) as the port's dict of tensors on
    `device` (default: the card), with the host-side chaining values carried
    over as they are."""
    device = pick_device(device=device)
    out = {k: from_numpy(ctx[k], device) for k in ("bl", "zr", "zr_bytes")
           if k in ctx}
    out["bp"] = {k: from_numpy(v, device) for k, v in ctx["bp"].items()}
    out.update({k: ctx[k] for k in ("_b", "_zr_bytes", "_bp_point")
                if k in ctx})
    return out


def verify_ctx_from_jax(ctx, device=None):
    """A verify context of the JAX package (curve25519_tpu.models.ed25519.
    verify_init: pk uint8, planes int8, ok bool) as the port's on `device`
    (default: the card)."""
    device = pick_device(device=device)
    return {k: from_numpy(ctx[k], device) for k in ("pk", "planes", "ok")}
