"""Broken versions of the port's API calls, put in place of the real ones by
the tests that show the correctness check fails: the control (a guarantee
broken) and the faults the cells can have. The benchmark's runs never use
them.

Each takes the real function and returns its broken stand-in.
"""

import torch


def stale(fn):
    """The control: results reused across calls. The first call computes;
    every later call returns that call's result, whatever its inputs."""
    kept = []

    def call(*args, **kwargs):
        if not kept:
            kept.append(fn(*args, **kwargs))
        return kept[0]
    return call


def unchanged(fn):
    """A step that returns its state unchanged: the answer is the call's
    first batched input, cut or padded to the answer's shape (for a
    verdict: the comparison of an R' left as R, so every lane accepted)."""
    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        if out.dtype == torch.bool:
            return torch.ones_like(out)
        first = next(a for a in args if a.ndim == 2
                     and a.shape[0] == out.shape[0])[:, :out.shape[1]]
        return torch.nn.functional.pad(first, (0, out.shape[1]
                                               - first.shape[1]))
    return call


def half(fn):
    """Half of the batch left out: the answers of the second half of the
    lanes are never computed (left zero, or False)."""
    def call(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return call


def altered(fn):
    """An answer altered where it is produced: lane 1's answer has one bit
    flipped (a verdict negated)."""
    def call(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        if out.dtype == torch.bool:
            out[1] = ~out[1]
        else:
            out[1, 0] ^= 1
        return out
    return call
