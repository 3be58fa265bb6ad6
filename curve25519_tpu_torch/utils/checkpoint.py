"""Saving precomputed contexts (counterpart of
curve25519_tpu/utils/checkpoint.py).

A pytree of tensors or arrays (dicts, lists, tuples) goes into one `.npz`
in the JAX package's layout: a leaf at tree path k1/k2/... is the entry
"t/k1/k2/...", dict keys in sorted order, keys that start with "_"
(host-side values such as a blinding context's "_b") are not saved, and
the entry "__curve25519_tpu_pytree__" holds the tree's structure as JSON.
So a verify context saved by either package loads in the other. Verify
once per public key, then ship the q_table to every worker.
"""

import json
import os

import numpy as np
import torch

from curve25519_tpu_torch.ops.cuda import pick_device

__all__ = ["save_pytree", "load_pytree", "save_verify_ctx", "load_verify_ctx"]

_SENTINEL = "__curve25519_tpu_pytree__"


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        spec = {}
        for k, v in sorted(tree.items()):
            if k.startswith("_"):
                continue
            spec[k] = _flatten(v, "%s/%s" % (prefix, k), out)
        return {"kind": "dict", "children": spec}
    if isinstance(tree, (list, tuple)):
        spec = [_flatten(v, "%s/%d" % (prefix, i), out)
                for i, v in enumerate(tree)]
        return {"kind": "list" if isinstance(tree, list) else "tuple",
                "children": spec}
    out[prefix] = (tree.detach().cpu().numpy()
                   if isinstance(tree, torch.Tensor) else np.asarray(tree))
    return {"kind": "leaf", "key": prefix}


def _unflatten(spec, arrays, leaf):
    kind = spec["kind"]
    if kind == "dict":
        return {k: _unflatten(s, arrays, leaf)
                for k, s in spec["children"].items()}
    if kind in ("list", "tuple"):
        vals = [_unflatten(s, arrays, leaf) for s in spec["children"]]
        return vals if kind == "list" else tuple(vals)
    return leaf(arrays[spec["key"]])


def save_pytree(path, tree):
    """Write a pytree of tensors (any device) or arrays to `path` (np.savez
    adds ".npz" when it is missing)."""
    out = {}
    spec = _flatten(tree, "t", out)
    out[_SENTINEL] = np.frombuffer(json.dumps(spec).encode(), np.uint8)
    np.savez(path, **out)


def load_pytree(path, device=None, to_torch=True):
    """A pytree saved by save_pytree (of either package), its leaves as
    tensors on `device` (default: the card), or as numpy arrays with
    to_torch=False. `path` may leave out the ".npz"."""
    if not os.path.exists(path) and os.path.exists(str(path) + ".npz"):
        path = str(path) + ".npz"
    with np.load(path) as z:
        spec = json.loads(bytes(z[_SENTINEL]).decode())
        arrays = {k: z[k] for k in z.files if k != _SENTINEL}
    if not to_torch:
        return _unflatten(spec, arrays, lambda a: a)
    dev = pick_device(device=device)
    return _unflatten(spec, arrays, lambda a: torch.from_numpy(a).to(dev))


def save_verify_ctx(path, ctx):
    """Save a verify_init() context (pk, q_table planes, ok flags)."""
    save_pytree(path, ctx)


def load_verify_ctx(path, device=None):
    """A verify context ready for verify_check(), on `device` (default: the
    card)."""
    return load_pytree(path, device=device)
