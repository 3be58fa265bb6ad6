"""The benchmark's engine: it finds a cell's files by name, makes the inputs,
warms up, drives the cell's loop, checks what the timed path produced
against the plain reference and reads the per-layer metrics.

Files, each found by the name that BENCHMARK.json or the workload gives:

- workloads/<cell>.json: the cell's config, loop, traffic parameters
  (with `batch`, the lanes of a call, and `pool`, the distinct batches
  made), which of the loop's quantities it reports under which end-to-end
  name (`report`) and the lanes its correctness check samples;
- configs/<config>.json: the deployment;
- deployments/<config>.py: make(config, traffic, seed) -> the host-side
  inputs of `pool` distinct batches, batch after batch; setup(config, made, device) -> state; run_batch(state, lanes,
  span) -> the outputs in host memory, from inputs in host memory (the
  helpers host_buffers and fetch keep both page-locked on a card);
  work(config, made) -> the frozen work of each API call of a batch, for
  the bound;
- reference/<config>.py: judge(config, made, lanes, outputs) -> {check:
  (number, limit)}, the plain reference's verdict on sampled lanes;
- loops/<loop>.py: run(cell) -> the end-to-end metrics of the window;
- metrics/<metric>.py: read(reading) -> a per-layer number or None.

Nothing here knows a cell, a configuration or a metric by name.
"""

import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WARMUP_BATCHES = 2


def load_module(path):
    """Import the Python file at `path` as a module of its own."""
    path = Path(path)
    name = "portbench_%s_%s" % (path.parent.name, path.stem.replace(".", "_"))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Files:
    """The files of one cell under a benchmark directory (default this
    one), found by name."""

    def __init__(self, workload, root=HERE):
        self.root = Path(root)
        self.workload_name = workload
        self.workload = load_json(self.root / "workloads" / (workload
                                                            + ".json"))
        name = self.workload["config"]
        self.config = load_json(self.root / "configs" / (name + ".json"))
        self.deployment = load_module(self.root / "deployments"
                                      / (name + ".py"))
        self.reference = load_module(self.root / "reference" / (name + ".py"))
        self.loop = load_module(self.root / "loops"
                                / (self.workload["loop"] + ".py"))

    def metric(self, name):
        return load_module(self.root / "metrics" / (name + ".py"))


class Spans:
    """The benchmark's spans: span(name) is a context manager that, when
    tracing, keeps (start, end, name) in wall-clock nanoseconds
    (time.time_ns, the clock of torch.profiler's events) in `kept`; when
    not tracing it does nothing."""

    def __init__(self, trace):
        self.on = bool(trace)
        self.kept = []

    @contextlib.contextmanager
    def _record(self, name):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.kept.append((t0, time.time_ns(), name))

    def __call__(self, name):
        return self._record(name) if self.on else contextlib.nullcontext()


def host_buffers(shapes, n, device):
    """{name: [n, *shape] tensor in host memory}, page-locked where the
    device is a card, so that copies to and from it are DMA; shapes:
    {name: (shape of a lane, dtype)}."""
    import torch
    pin = device.type == "cuda"
    return {k: torch.empty((n,) + tuple(shape), dtype=dtype, pin_memory=pin)
            for k, (shape, dtype) in shapes.items()}


def fetch(buffers, outputs):
    """Copy device tensors into the first rows of their host buffers, wait
    for the copies, and return the rows as numpy arrays."""
    import torch
    cuda = False
    for k, t in outputs.items():
        buffers[k][:len(t)].copy_(t, non_blocking=True)
        cuda = cuda or t.is_cuda
    if cuda:
        torch.cuda.current_stream().synchronize()
    return {k: buffers[k][:len(t)].numpy() for k, t in outputs.items()}


def percentile(values, weights, q):
    """The nearest-rank q-th percentile of values, each counted `weights`
    times."""
    order = np.argsort(values, kind="stable")
    cum = np.cumsum(np.asarray(weights, dtype=np.float64)[order])
    rank = np.ceil(q / 100 * cum[-1])
    return float(np.asarray(values)[order][np.searchsorted(cum, rank)])


class Sampler:
    """The lanes the correctness check reads: after each batch, `per_batch`
    rows drawn from each stratum of the deployment (a named set of lanes;
    None is every lane), kept with their outputs; once the window has
    closed, at most `cap` of each stratum, drawn from the seed. Pooled
    batch p holds the made lanes p * n to (p + 1) * n."""

    def __init__(self, strata, check, pool, n, seed):
        self.rng = np.random.default_rng([seed % 2**63, 2])
        self.check, self.n = check, n
        self.kept = {name: ([], {}) for name in check}
        # rows of each stratum in each pooled batch
        self.rows = {}
        for name in check:
            lanes = strata[name]
            for p in range(pool):
                self.rows[name, p] = None if lanes is None else np.sort(
                    lanes[(lanes >= p * n) & (lanes < (p + 1) * n)] - p * n)

    def take(self, p, outputs):
        """Keep sampled rows of the outputs of pooled batch p."""
        for name, rule in self.check.items():
            rows = self.rows[name, p]
            if rows is None:
                rows = self.rng.choice(self.n, min(rule["per_batch"],
                                                   self.n), replace=False)
            else:
                rows = self.rng.choice(rows, min(rule["per_batch"],
                                                 len(rows)), replace=False)
            lanes, outs = self.kept[name]
            lanes.append(p * self.n + rows)
            for k, v in outputs.items():
                outs.setdefault(k, []).append(v[rows].copy())

    def sample(self):
        """(lanes, {output: rows}) of every stratum together, each stratum
        cut to its cap."""
        lanes, outs = [], {}
        for name, rule in self.check.items():
            got, o = self.kept[name]
            if not got:
                continue
            got = np.concatenate(got)
            keep = np.sort(self.rng.permutation(len(got))[:rule["cap"]])
            lanes.append(got[keep])
            for k, v in o.items():
                outs.setdefault(k, []).append(np.concatenate(v)[keep])
        if not lanes:
            return np.zeros(0, np.int64), {}
        return (np.concatenate(lanes),
                {k: np.concatenate(v) for k, v in outs.items()})


def pinned(arrays, device):
    """numpy arrays as host tensors, page-locked where the device is a
    card (a server's registered network buffers)."""
    import torch
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in arrays.items()}
    if device.type == "cuda":
        out = {k: v.pin_memory() for k, v in out.items()}
    return out


class Cell:
    """One run of a cell: the inputs of `pool` distinct batches made on the
    host from the seed and kept in host memory, the program set up, and
    what the loop needs to drive it (`batch`, `seconds`, `params`, `span`).
    `make_s` is the time the benchmark took to make the inputs (its own
    plain code, as the reference's is). `batch` and `check` replace the
    workload's batch size and sampling rule (tests run tiny batches and
    read every lane)."""

    def __init__(self, files, seed, seconds, trace, device, batch=None,
                 check=None):
        self.files, self.seconds = files, seconds
        self.params = dict(files.workload["traffic"])
        if batch is not None:
            self.params["batch"] = batch
        self.span = Spans(trace)
        dep = files.deployment
        t0 = time.perf_counter()
        self.made = dep.make(files.config, self.params, seed)
        self.make_s = time.perf_counter() - t0
        n, pool = self.params["batch"], self.params["pool"]
        lanes = pinned(self.made["lanes"], device)
        if len(next(iter(lanes.values()))) != n * pool:
            raise ValueError("make gave no %d batches of %d lanes"
                             % (pool, n))
        self.pool = [{k: v[p * n:(p + 1) * n] for k, v in lanes.items()}
                     for p in range(pool)]
        self.lanes = n
        self.sampler = Sampler(self.made["strata"],
                               check or files.workload["check"], pool, n,
                               seed)
        self.state = dep.setup(files.config, self.made, device)

    def warm_up(self):
        """Run the cell's own shape; no sample is kept."""
        for i in range(WARMUP_BATCHES):
            self.files.deployment.run_batch(self.state, self.pool[-1 - i],
                                            self.span)

    def batch(self, i):
        """Run pooled batch i % pool through the program and sample its
        outputs. Returns the operations completed."""
        p = i % len(self.pool)
        with self.span("loop"):
            out = self.files.deployment.run_batch(self.state, self.pool[p],
                                                  self.span)
        self.sampler.take(p, out)
        return self.lanes * self.files.config["ops_per_lane"]

    def release(self):
        """Drop the program's state and the pooled inputs."""
        self.state = self.pool = None

    def judge(self):
        """{number compared: {"value", and "max" or "min"}}: each check of
        the plain reference over the sampled lanes with its upper limit, and
        how many lanes it read, at least one."""
        lanes, outs = self.sampler.sample()
        checks = {k: {"value": v, "max": limit}
                  for k, (v, limit) in self.files.reference.judge(
                      self.files.config, self.made, lanes, outs).items()}
        checks["lanes_checked"] = {"value": len(lanes), "min": 1}
        return checks


def check_passed(checks):
    """Every number compared within its limit."""
    return all(c["value"] <= c.get("max", c["value"])
               and c["value"] >= c.get("min", c["value"])
               for c in checks.values())


def metrics_for(benchmark, cell, kind):
    """The entries of BENCHMARK.json's `kind` list that `cell` reports: an
    entry with a `workloads` key where it lists the cell, one without it in
    every cell."""
    return [m for m in benchmark[kind] if cell in m.get("workloads", [cell])]


class Reading:
    """What a per-layer metric's reader reads: the trace of the window
    (with the number of batches in it) and the frozen work of each API call
    of a batch (deployment.work)."""

    def __init__(self, trace, work):
        self.trace, self.work = trace, work

    def roofline(self, call):
        """The frozen bound of `call`'s work over the summed device time of
        the hand-written kernels it launched, in percent; None when it
        launched none in the window."""
        from portbench import bound
        kernel_s = self.trace.seconds(glue=False, span="api:" + call)
        if not kernel_s or call not in self.work:
            return None
        return 100 * bound.seconds(self.work[call]) * self.trace.batches \
            / kernel_s

    def glue_ms(self):
        """Device milliseconds of glue (PyTorch's own kernels, copies and
        sets) a batch; None when the trace holds no device event."""
        if not self.trace.events:
            return None
        return 1e3 * self.trace.seconds(glue=True) / self.trace.batches

    def idle_pct(self):
        """The share of the window in which no device event ran, percent;
        None when the trace holds no device event."""
        if not self.trace.events:
            return None
        return 100 * (1 - self.trace.busy_s() / self.trace.window_s)


def log(*args):
    print(*args, file=sys.stderr, flush=True)
