"""Timing and tracing on the GPU (counterpart of
curve25519_tpu/utils/profiling.py).

`bench` keeps the discipline of the JAX package: warm up first, then
best-of-`rounds` of the mean of `reps` independent calls. The clock is a
pair of CUDA events around the calls on the current stream, so the time is
the device's, not the time to enqueue; a measurement without a card fails.
`trace` records a torch.profiler trace into a Chrome trace file, which
`trace_summary` and `trace_device_events` aggregate by event name.
`Counter` and `timed` count operations against host seconds.
"""

import contextlib
import glob
import json
import os
import tempfile
import time

import torch

__all__ = ["bench", "trace", "trace_summary", "trace_device_events",
           "Counter", "timed"]

# the trace categories of work on the device: kernels and memory traffic
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


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


def _sync():
    """Wait for the card, when this process has used one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir=None):
    """Record the host and (with a card) the device activity of the block
    with torch.profiler; on exit the Chrome trace is written under `logdir`
    (default: a new temporary directory), which the context yields."""
    from torch.profiler import ProfilerActivity, profile
    logdir = logdir or tempfile.mkdtemp(prefix="curve25519_torch_trace_")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    _sync()
    prof.start()
    try:
        yield logdir
    finally:
        _sync()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, "%020d.%d.trace.json" % (time.time_ns(), os.getpid())))


def _events(logdir):
    paths = sorted(glob.glob(os.path.join(logdir, "*.trace.json")))
    if not paths:
        raise FileNotFoundError("no trace under %s" % logdir)
    with open(paths[-1]) as f:
        return json.load(f)["traceEvents"]


def _aggregate(events, keep):
    agg = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e or not keep(e):
            continue
        d = agg.setdefault(e.get("name", "?"), {"total_us": 0.0, "count": 0})
        d["total_us"] += float(e["dur"])
        d["count"] += 1
    return dict(sorted(agg.items(), key=lambda kv: -kv[1]["total_us"]))


def trace_summary(logdir, prefix=None):
    """{event name: {"total_us", "count"}} of the newest trace under
    `logdir`, most expensive first; `prefix` keeps the names that start
    with it."""
    return _aggregate(_events(logdir), lambda e: prefix is None or e.get(
        "name", "?").startswith(prefix))


def trace_device_events(logdir):
    """trace_summary of the device's events only: CUDA kernels, copies and
    sets. Their sum against the host wall time is the device's busy share,
    and their sum less the named kernels the glue between them."""
    return _aggregate(_events(logdir),
                      lambda e: e.get("cat") in _DEVICE_CATEGORIES)


class Counter:
    """Throughput counter: accumulate (ops, seconds), report ops/s."""

    def __init__(self, name):
        self.name = name
        self.ops = 0
        self.seconds = 0.0

    def add(self, ops, seconds):
        self.ops += ops
        self.seconds += seconds

    @property
    def ops_per_s(self):
        return self.ops / self.seconds if self.seconds else 0.0

    def json(self, baseline_ops_per_s=None):
        d = {"metric": self.name, "value": round(self.ops_per_s, 1),
             "unit": "ops/s"}
        if baseline_ops_per_s:
            d["vs_baseline"] = round(self.ops_per_s / baseline_ops_per_s, 3)
        return json.dumps(d)


@contextlib.contextmanager
def timed(counter, ops):
    """Time a block on the host clock and add it to a Counter. Where this
    process has used a card, the card is synchronized before each reading,
    so the time covers the work and not only its enqueue."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    counter.add(ops, time.perf_counter() - t0)
