"""Reading a torch.profiler trace of the measured window.

The harness keeps its own spans on the host's wall clock: a `loop` span
around each batch and, inside it, the copies in (`h2d`), each call of the
program's API (`api:<call>`) and the copies out (`d2h`). The profiler
records only the card's activity: kernels, copies and sets, and the CUDA
runtime calls that launched them, on the same wall clock less the trace's
base time. A device event belongs to the span that was open on the host
when it was launched: the trace links the two through the launch's
correlation id.

Kernels are split in two: the program's own, hand-written kernels, and
glue, which is PyTorch's own kernels and every copy and set. PyTorch's
kernels are told by their C++ namespaces, so the split survives a renamed
or fused hand-written kernel.
"""

import bisect
import json
import re

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
LOOP = "loop"

_TORCH_KERNEL = re.compile(r"\b(at|c10|at_cuda_detail|cub|thrust|cuda_cub)::")


def is_glue(event):
    """Whether a device event is glue: a copy, a set, or a kernel of
    PyTorch's own."""
    return event["cat"] != "kernel" or bool(_TORCH_KERNEL.search(
        event["name"]))


def load(path):
    """(events, base time in ns) of a Chrome trace that torch.profiler's
    export_chrome_trace wrote: event times are microseconds after the
    base, which is on the wall clock."""
    with open(path) as f:
        trace = json.load(f)
    return trace["traceEvents"], int(trace.get("baseTimeNanoseconds", 0))


class Trace:
    """The device events of a traced window, each with the benchmark span
    it was launched from, and the window's extent.

    events: the Chrome trace's event list; base_ns: its base time; spans:
    the harness's [(start, end, name)] in wall-clock nanoseconds. Times
    are kept in seconds on the trace's clock."""

    def __init__(self, events, base_ns, spans):
        spans = [((t0 - base_ns) * 1e-9, (t1 - base_ns) * 1e-9, name)
                 for t0, t1, name in spans]
        launches, device = {}, []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat")
            if cat in LAUNCH_CATEGORIES:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = e["ts"] * 1e-6
            elif cat in DEVICE_CATEGORIES:
                device.append(e)
        loops = [s for s in spans if s[2] == LOOP]
        if not loops:
            raise ValueError("no %r span in the window" % LOOP)
        self.batches = len(loops)
        self.start = min(s[0] for s in loops)
        self.end = max(s[1] for s in loops)
        inner = sorted(s for s in spans if s[2] != LOOP)
        self._spans = inner
        self._starts = [s[0] for s in inner]
        self.events = []
        for e in device:
            t0 = e["ts"] * 1e-6
            t1 = t0 + e["dur"] * 1e-6
            if t1 <= self.start or t0 >= self.end:
                continue
            launch = launches.get(e.get("args", {}).get("correlation"))
            self.events.append({
                "name": e["name"], "cat": e["cat"], "start": t0, "end": t1,
                "glue": is_glue(e),
                "span": None if launch is None else self.span_at(launch)})

    def unattributed(self):
        """The share of the window's device seconds whose launch lay in no
        h2d, api or d2h span (0 when the clocks agree)."""
        total = self.seconds()
        inner = {s[2] for s in self._spans}
        return 1 - sum(self.seconds(span=n) for n in inner) / total \
            if total else 0.0

    @property
    def window_s(self):
        return self.end - self.start

    def span_at(self, t):
        """The name of the benchmark span open at host time t: `h2d`,
        `api:<call>` or `d2h` (they follow one another, none inside
        another), else `loop` inside the window, else `none`."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t < self._spans[i][1]:
            return self._spans[i][2]
        return LOOP if self.start <= t < self.end else "none"

    def seconds(self, glue=None, span=None):
        """Summed device seconds in the window, of glue (True), hand-written
        kernels (False) or both (None), launched from `span` (any when
        None)."""
        return sum(min(e["end"], self.end) - max(e["start"], self.start)
                   for e in self.events
                   if (glue is None or e["glue"] == glue)
                   and (span is None or e["span"] == span))

    def busy(self):
        """The union of device-busy intervals, clipped to the window, as a
        sorted list of disjoint (start, end)."""
        out = []
        for e in sorted(self.events, key=lambda e: e["start"]):
            t0, t1 = max(e["start"], self.start), min(e["end"], self.end)
            if out and t0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t1)
            else:
                out.append([t0, t1])
        return [tuple(x) for x in out]

    def busy_s(self):
        return sum(t1 - t0 for t0, t1 in self.busy())

    def idle_gaps(self):
        """[(span the host was in when the gap began, seconds)] of every
        gap between busy intervals inside the window."""
        gaps, t = [], self.start
        for t0, t1 in self.busy() + [(self.end, self.end)]:
            if t0 > t:
                gaps.append((self.span_at(t), t0 - t))
            t = max(t, t1)
        return gaps

    def breakdown(self, top=10):
        """{"device_ops": [[name, seconds]], "idle_gaps": [[span, seconds]]}:
        device seconds by operation name and idle seconds by host span,
        largest first, at most `top` of each."""
        ops = {}
        for e in self.events:
            name = short_name(e["name"])
            ops[name] = ops.get(name, 0.0) + (min(e["end"], self.end)
                                              - max(e["start"], self.start))
        gaps = {}
        for name, s in self.idle_gaps():
            gaps[name] = gaps.get(name, 0.0) + s

        def largest(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": largest(ops), "idle_gaps": largest(gaps)}


def short_name(name, width=96):
    """A device operation's name without its argument list, at most
    `width` characters."""
    name = name[5:] if name.startswith("void ") else name
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and not name.startswith(
                "(anonymous namespace)", i):
            cut = i
            break
    return name[:cut][:width]
