"""The program's own spans in a traced run of a cell.

The port records spans inside itself (curve25519_tpu_torch/utils/profiling:
`span`, `start_spans`, `stop_spans`): each API call, the glue pieces
around its kernels, each kernel launch (`launch.<library>`) and the set-up
it does at first use (`build.load_cuda.<library>`, `build.nvcc.<library>`,
the `edwards_kernel` tables, `blinding.static_zr`), as (start_ns, end_ns,
name, parent, n) on the wall clock of the harness's spans and of
torch.profiler's trace. `SpanTrace` reads them beside the harness's spans
and the device events:

- each device event's innermost program span, by the time it was launched
  (the trace links launch and event through their correlation id);
- each idle gap's innermost program span when the gap began, else the
  harness span open then;
- each top-level program span's batch: the `loop` span that holds it;
- host seconds, glue device seconds and set-up seconds by program span;
- for each span with a work count, the count a batch and the host and
  device nanoseconds a unit of it.

The port's import cannot be a span of its own (the recorder is part of
it), so `main` times it and adds it as the set-up span
`import.curve25519_tpu_torch`. The program's set-up (`setup.program_s`) is
that import, the set-up spans outside the API, and what each API span's
first call took beyond its median call in the window: the first call also
sets up what no span names (torch's own first-use imports, the card's
lazily loaded kernels).

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell as portbench/run.py does (the same `run.measure`), with the
program's spans recorded from before set-up to the end of the window, and
prints run.py's result object with a `spans` object added as its last line:
with --trace 1 the readings of PROGRAM_METRICS, the lists `glue_spans`,
`idle_spans`, `host_spans`, `setup_spans`, `warmup_spans` and
`work_spans`, the share of
each API span's glue that falls in a named child span, and how many
program spans lay outside the harness's `api:<call>` span of their batch;
with --trace 0 the number of spans kept and the host milliseconds a call
of each top-level span after warm-up (the end-to-end metrics then show
what recording costs, and the host times carry no profiler's cost). A
result line of run.py is unchanged by this module.
"""

import time

T_START = time.perf_counter()

import bisect  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import trace  # noqa: E402

# Program spans of set-up, by the start of their names: the port's import
# (timed by main) and what it does at first use.
SETUP = ("import.", "build.", "edwards_kernel.", "blinding.")
IMPORT = "import.curve25519_tpu_torch"

TLS_API = ("x25519.calculate_public_key_fast", "x25519.create_shared_key",
           "ed25519.sign")
DIGITS = ("sc.from_digest", "fold.cut8_bytes", "fold.cut4_limbs")

TLS, PACKETS = ("tls13.batch",), ("sigverify.padded",)

# name: (the cells it is read in, unit, reader of a SpanTrace)
PROGRAM_METRICS = {
    "api.host_ms.tls13": (TLS, "ms", lambda t: t.host_ms(TLS_API)),
    "api.host_ms.sigverify": (PACKETS, "ms",
                              lambda t: t.host_ms(("ed25519.verify",))),
    "glue.pack_ms.tls13": (TLS, "ms",
                           lambda t: t.glue_ms(("sha512.pack_words",))),
    "glue.pack_ms.sigverify": (PACKETS, "ms",
                               lambda t: t.glue_ms(("sha512.pack_words",))),
    "glue.digits_ms.sigverify": (PACKETS, "ms", lambda t: t.glue_ms(DIGITS)),
    "setup.program_s": (TLS + PACKETS, "s", lambda t: t.setup_s()),
}


def is_setup(name):
    return name.startswith(SETUP)


class ProgramSpans:
    """Program span records on the trace's clock (seconds after base_ns):
    start, end, name, parent index (-1 for none) and work count."""

    def __init__(self, records, base_ns):
        self.records = records
        self.start = [(r[0] - base_ns) * 1e-9 for r in records]
        self.end = [(r[1] - base_ns) * 1e-9 for r in records]
        self.name = [r[2] for r in records]
        self.parent = [r[3] for r in records]
        self.n = [r[4] for r in records]
        # spans begin in record order; a span's start is never before its
        # parent's, so the starts are sorted
        self._order = sorted(range(len(records)), key=self.start.__getitem__)
        self._starts = [self.start[i] for i in self._order]

    def __len__(self):
        return len(self.name)

    def at(self, t):
        """The index of the innermost span open at t, or -1. Spans nest, so
        it is the last span begun by t or one of its ancestors."""
        k = bisect.bisect_right(self._starts, t) - 1
        i = self._order[k] if k >= 0 else -1
        while i >= 0 and not t < self.end[i]:
            i = self.parent[i]
        return i

    def ancestors(self, i):
        """i and its enclosing spans, innermost first."""
        while i >= 0:
            yield i
            i = self.parent[i]

    def self_s(self):
        """Each span's duration less its children's."""
        from curve25519_tpu_torch.utils import profiling
        return [1e-9 * ns for ns in profiling.self_ns(self.records)]


def host_ms_a_call(records, skip):
    """{top-level span name: mean host milliseconds of its calls after the
    first `skip`}: the API's host time where no trace ties calls to
    batches."""
    calls = {}
    for t0, t1, name, parent, _ in records:
        if parent < 0:
            calls.setdefault(name, []).append(t1 - t0)
    return {k: 1e-6 * sum(v[skip:]) / len(v[skip:])
            for k, v in calls.items() if len(v) > skip}


def joined(before, records):
    """The spans `before` (top-level, timed outside the recording) followed
    by a recording's records, their parents moved to match."""
    k = len(before)
    return list(before) + [(t0, t1, name, parent + k if parent >= 0 else -1,
                            n) for t0, t1, name, parent, n in records]


def _largest(d, top):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]


class SpanTrace(trace.Trace):
    """A Trace (unchanged, so every reading of the harness stays as it
    was) with the program's spans beside it. records: profiling.stop_spans()
    of the run."""

    def __init__(self, events, base_ns, spans, records):
        super().__init__(events, base_ns, spans)
        self.program = ProgramSpans(records, base_ns)
        # Trace keeps no correlation id: walk the events again for each
        # event's launch, keyed by start, end and name; events with one key
        # come in trace order, as Trace took them
        launches, launch_of = {}, {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in \
                    trace.LAUNCH_CATEGORIES:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = e["ts"] * 1e-6
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in \
                    trace.DEVICE_CATEGORIES and "dur" in e:
                t0 = e["ts"] * 1e-6
                launch_of.setdefault((t0, t0 + e["dur"] * 1e-6, e["name"]),
                                     []).append(launches.get(
                                         e.get("args", {}).get(
                                             "correlation")))
        for ls in launch_of.values():
            ls.reverse()
        for e in self.events:
            e["launch"] = launch_of[e["start"], e["end"], e["name"]].pop()
            e["program"] = -1 if e["launch"] is None else \
                self.program.at(e["launch"])
        self.loops = sorted(((a - base_ns) * 1e-9, (b - base_ns) * 1e-9)
                            for a, b, n in spans if n == trace.LOOP)

    def _clipped(self, e):
        return min(e["end"], self.end) - max(e["start"], self.start)

    def name_at(self, t):
        """The innermost program span open at host time t, else the
        harness's span then."""
        i = self.program.at(t)
        return self.program.name[i] if i >= 0 else self.span_at(t)

    def batch_of(self, i):
        """The index of the batch (loop span) that holds program span i,
        or None (set-up, warm-up)."""
        p = self.program
        k = bisect.bisect_right(self.loops, (p.start[i], float("inf"))) - 1
        if k >= 0 and p.end[i] <= self.loops[k][1]:
            return k
        return None

    def top_level(self):
        """[(index, batch)] of the program spans with no parent that lie in
        a batch of the window."""
        out = []
        for i, parent in enumerate(self.program.parent):
            if parent < 0:
                b = self.batch_of(i)
                if b is not None:
                    out.append((i, b))
        return out

    def outside_api(self):
        """The top-level program spans of the window's batches that lie in
        no `api:<call>` span of the harness."""
        p, count = self.program, 0
        for i, _ in self.top_level():
            k = bisect.bisect_right(self._starts, p.start[i]) - 1
            if k < 0 or not self._spans[k][2].startswith("api:") \
                    or p.end[i] > self._spans[k][1]:
                count += 1
        return count

    def host_ms(self, names):
        """Host milliseconds a batch inside the top-level program spans
        named `names`; None when the window holds none."""
        p = self.program
        spans = [i for i, _ in self.top_level() if p.name[i] in names]
        if not spans:
            return None
        return 1e3 * sum(p.end[i] - p.start[i] for i in spans) / self.batches

    def glue_ms(self, names):
        """Device milliseconds a batch of glue launched with one of `names`
        the innermost program span; None when no such glue ran."""
        p = self.program
        got = [e for e in self.events if e["glue"] and e["program"] >= 0
               and p.name[e["program"]] in names]
        if not got:
            return None
        return 1e3 * sum(self._clipped(e) for e in got) / self.batches

    def setup_parts(self):
        """{part: seconds} of the program's set-up: each set-up span that
        neither another set-up span nor an API span's first call holds (the
        import, loads, builds, tables) and, for each API span of the window
        first called before it, what that first call took beyond the median
        of its calls in the window (`first_call.<span>`, the set-up spans
        inside it included)."""
        p, window = self.program, {}
        for i, _ in self.top_level():
            window.setdefault(p.name[i], []).append(p.end[i] - p.start[i])
        first, parts = {}, {}
        for i in range(len(p)):
            if p.parent[i] < 0 and p.name[i] in window:
                first.setdefault(p.name[i], i)
        first = {k: i for k, i in first.items() if self.batch_of(i) is None}
        for name, i in first.items():
            parts["first_call." + name] = max(
                0.0, p.end[i] - p.start[i] - statistics.median(window[name]))
        firsts = set(first.values())
        for i in range(len(p)):
            up = list(p.ancestors(i))
            if is_setup(p.name[i]) and up[-1] not in firsts and not any(
                    is_setup(p.name[a]) for a in up[1:]):
                parts[p.name[i]] = parts.get(p.name[i], 0.0) + p.end[i] \
                    - p.start[i]
        return parts

    def setup_s(self):
        """The seconds of setup_parts(); None when there is none."""
        parts = self.setup_parts()
        return sum(parts.values()) if parts else None

    def glue_spans(self, top=10):
        """[[span, seconds]]: the window's glue device seconds by innermost
        program span (the harness's span where no program span was open),
        largest first."""
        out = {}
        for e in self.events:
            if e["glue"]:
                k = self.program.name[e["program"]] if e["program"] >= 0 \
                    else e["span"]
                out[k] = out.get(k, 0.0) + self._clipped(e)
        return _largest(out, top)

    def idle_spans(self, top=10):
        """[[span, seconds]]: the window's idle seconds by the program span
        open when each gap began (the harness's span where none was)."""
        out, t = {}, self.start
        for t0, t1 in self.busy() + [(self.end, self.end)]:
            if t0 > t:
                k = self.name_at(t)
                out[k] = out.get(k, 0.0) + t0 - t
            t = max(t, t1)
        return _largest(out, top)

    def host_spans(self, top=10):
        """[[span, seconds]]: host self seconds of the window's batches by
        program span name."""
        p, own, out = self.program, self.program.self_s(), {}
        for i in range(len(p)):
            top_i = list(p.ancestors(i))[-1]
            if self.batch_of(top_i) is not None:
                out[p.name[i]] = out.get(p.name[i], 0.0) + own[i]
        return _largest(out, top)

    def setup_spans(self, top=10):
        """[[span, seconds]]: the parts of setup_s and the set-up spans by
        name, each counted in full (a build inside a load, or a load inside
        a first call, counts in both)."""
        p = self.program
        out = {k: v for k, v in self.setup_parts().items()
               if not is_setup(k)}
        for i in range(len(p)):
            if is_setup(p.name[i]):
                out[p.name[i]] = out.get(p.name[i], 0.0) + p.end[i] - \
                    p.start[i]
        return _largest(out, top)

    def warmup_spans(self, top=10):
        """[[span, seconds]]: host self seconds by program span name of
        everything outside the window's batches (set-up and warm-up)."""
        p, own, out = self.program, self.program.self_s(), {}
        for i in range(len(p)):
            if self.batch_of(list(p.ancestors(i))[-1]) is None:
                out[p.name[i]] = out.get(p.name[i], 0.0) + own[i]
        return _largest(out, top)

    def work_spans(self):
        """[[span, units a batch, host ns a unit, device ns a unit]] by
        name, of the window's program spans with a work count n (lanes,
        bytes): n a batch, and the host seconds of the spans and the device
        seconds of every event launched inside them (their children's
        launches too) per unit of n."""
        p, units, host, dev = self.program, {}, {}, {}
        tops = {i for i, _ in self.top_level()}
        inside = [list(p.ancestors(i))[-1] in tops for i in range(len(p))]
        for i in range(len(p)):
            if inside[i] and p.n[i]:
                units[p.name[i]] = units.get(p.name[i], 0) + p.n[i]
                host[p.name[i]] = host.get(p.name[i], 0.0) + p.end[i] - \
                    p.start[i]
        for e in self.events:
            if e["program"] >= 0 and inside[e["program"]]:
                for a in p.ancestors(e["program"]):
                    if p.n[a]:
                        dev[p.name[a]] = dev.get(p.name[a], 0.0) + \
                            self._clipped(e)
        return [[k, units[k] / self.batches, 1e9 * host[k] / units[k],
                 1e9 * dev.get(k, 0.0) / units[k]] for k in sorted(units)]

    def coverage(self):
        """{API span: [glue seconds launched inside it, the share of them
        with a named child span innermost]} over the window."""
        p, out = self.program, {}
        for e in self.events:
            if not e["glue"] or e["program"] < 0:
                continue
            top_i = list(p.ancestors(e["program"]))[-1]
            if self.batch_of(top_i) is None:
                continue
            d = out.setdefault(p.name[top_i], [0.0, 0.0])
            d[0] += self._clipped(e)
            if e["program"] != top_i:
                d[1] += self._clipped(e)
        return {k: [s, c / s if s else 1.0] for k, (s, c) in out.items()}

    def report(self, cell):
        """The spans object of a traced run of `cell`."""
        metrics = {}
        for name, (cells, unit, read) in PROGRAM_METRICS.items():
            value = read(self) if cell in cells else None
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
        return {"metrics": metrics, "glue_spans": self.glue_spans(),
                "idle_spans": self.idle_spans(),
                "host_spans": self.host_spans(),
                "setup_spans": self.setup_spans(),
                "warmup_spans": self.warmup_spans(),
                "work_spans": self.work_spans(),
                "coverage": self.coverage(),
                "outside_api": self.outside_api(),
                "spans_kept": len(self.program)}


@contextlib.contextmanager
def recorded(profiling, before=()):
    """Record the program's spans for the block, and have the Trace that
    run.measure builds be a SpanTrace of them, after the spans `before`
    (kept["trace"]); the recording ends when that Trace is built, after
    the window."""
    kept, plain = {}, trace.Trace

    def build(events, base_ns, spans):
        kept["trace"] = SpanTrace(events, base_ns, spans,
                                  joined(before, profiling.stop_spans()))
        return kept["trace"]

    profiling.start_spans()
    trace.Trace = build
    try:
        yield kept
    finally:
        trace.Trace = plain
        kept["records"] = profiling.stop_spans()


def main(argv=None):
    from portbench import harness, run
    args = run.parse(argv)
    run.cache_dirs()
    import torch

    files = harness.Files(args.workload)
    t0 = time.time_ns()
    from curve25519_tpu_torch.utils import profiling
    for module, _ in files.deployment.API:
        importlib.import_module(module)
    imported = (t0, time.time_ns(), IMPORT, -1, None)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < files.workload["chips"]:
        harness.log("portbench: the cell needs %d CUDA card(s); this "
                    "machine has %d" % (files.workload["chips"], have))
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    with recorded(profiling, [imported]) as kept:
        result = run.measure(files, harness.load_json(run.ROOT
                                                      / "BENCHMARK.json"),
                             args.seed, args.seconds, args.trace, device,
                             t_start=T_START)
    if "trace" in kept:
        result["spans"] = kept["trace"].report(args.workload)
        for api, (s, share) in sorted(result["spans"]["coverage"].items()):
            harness.log("portbench: %s: glue %.6f s in the window, %.4f%% "
                        "of it in a named child span"
                        % (api, s, 100 * share))
    else:
        result["spans"] = {"spans_kept": len(kept["records"]),
                           "host_ms_a_call": host_ms_a_call(
                               kept["records"], harness.WARMUP_BATCHES)}
    found = run.forbidden_modules()
    if found:
        harness.log("portbench: forbidden modules imported: %s"
                    % ", ".join(found))
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
