"""Timing on the GPU (counterpart of curve25519_tpu/utils/profiling.bench).

The discipline is the same: warm up first, then best-of-`rounds` of the mean
of `reps` independent calls. The clock is a pair of CUDA events around the
calls on the current stream, so the time is the device's, not the time to
enqueue. There is no CPU fallback: a measurement without a card fails.
"""

import torch

__all__ = ["bench"]


def bench(fn, *args, reps=8, rounds=3):
    """Seconds per call of fn(*args) on the current CUDA device, after one
    warm-up call."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench() times on a CUDA device; none is available")
    fn(*args)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / reps)
    return best
