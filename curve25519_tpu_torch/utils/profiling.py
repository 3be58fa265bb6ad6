"""Timing and tracing on the GPU (counterpart of
curve25519_tpu/utils/profiling.py).

`bench` keeps the discipline of the JAX package: warm up first, then
best-of-`rounds` of the mean of `reps` independent calls. The clock is a
pair of CUDA events around the calls on the current stream, so the time is
the device's, not the time to enqueue; a measurement without a card fails.
`trace` records a torch.profiler trace into a Chrome trace file, which
`trace_summary` and `trace_device_events` aggregate by event name.
`Counter` and `timed` count operations against host seconds.

`span` marks where the program is on the host: its API calls, the glue
around the kernels, each kernel launch and the set-up done at first use.
Between `start_spans()` and `stop_spans()` every span is kept in memory as
(start_ns, end_ns, name, parent, n) on `time.time_ns`, the wall clock of
torch.profiler's Chrome trace (its `baseTimeNanoseconds`), so spans and
device events share one timeline; `parent` is the index of the enclosing
span or -1, `n` the work at that boundary (lanes, bytes) or None. Only the
caller that starts recording turns it on; off, a span is one flag read and
a shared no-op context. Spans are recorded from one thread.
"""

import contextlib
import functools
import glob
import json
import os
import tempfile
import time

import torch

__all__ = ["bench", "trace", "trace_summary", "trace_device_events",
           "Counter", "timed", "span", "spanned", "rows", "start_spans",
           "stop_spans", "self_ns"]

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
    sets, each name with its summed durations. Events on several streams
    may overlap, so the sum of every name's total can pass the time the
    device was busy: the busy time is the union of the events' intervals,
    which this summary does not give."""
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


# Program spans: the records of the current recording, the indices of the
# open spans, and whether a recording is on.
_recording = False
_records = []
_open = []


class _NoSpan:
    """The context of every span while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "n", "index", "record")

    def __init__(self, name, n):
        self.name, self.n = name, n

    def __enter__(self):
        self.index = len(_records)
        self.record = [time.time_ns(), None, self.name,
                       _open[-1] if _open else -1, self.n]
        _records.append(self.record)
        _open.append(self.index)

    def __exit__(self, *exc):
        self.record[1] = time.time_ns()
        if _open and _open[-1] == self.index:   # else the recording ended
            _open.pop()
        return False


def span(name, n=None):
    """A context that, while spans are recorded, keeps the block as a span
    named `name` with work count `n`; otherwise a shared no-op."""
    if not _recording:
        return _NO_SPAN
    return _Span(name, n)


def spanned(name, n=None):
    """Decorator: each call of the function is a span named `name`, whose
    work count is n(result) when `n` is given."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _recording:
                return fn(*args, **kwargs)
            sp = _Span(name, None)
            with sp:
                out = fn(*args, **kwargs)
                if n is not None:
                    sp.record[4] = n(out)
            return out
        return call
    return wrap


def rows(t):
    """The lanes of a [..., k] result: its rows of k."""
    return t.numel() // t.shape[-1]


def start_spans():
    """Begin a recording: spans from here on are kept until stop_spans()."""
    global _recording
    if _recording:
        raise RuntimeError("spans are already being recorded")
    _records.clear()
    _open.clear()
    _recording = True


def stop_spans():
    """End the recording; returns its spans as a list of (start_ns, end_ns,
    name, parent, n) in the order they began. A span still open ends now."""
    global _recording
    _recording = False
    now = time.time_ns()
    out = [(t0, now if t1 is None else t1, name, parent, n)
           for t0, t1, name, parent, n in _records]
    _records.clear()
    _open.clear()
    return out


def self_ns(records):
    """Each span's own time: its duration less its children's, in ns."""
    own = [t1 - t0 for t0, t1, _, _, _ in records]
    for t0, t1, _, parent, _ in records:
        if parent >= 0:
            own[parent] -= t1 - t0
    return own
