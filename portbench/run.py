"""Run one cell of the port's benchmark on the CUDA cards of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, portbench/ and the
program (curve25519_tpu_torch/). It makes the cell's inputs from the seed,
sets the program up and warms up the cell's own shape (set-up: setup_s is
process start to the first timed batch, less the seconds the benchmark's
own plain code took to make the inputs), drives the cell's loop for
`--seconds`, checks the sampled outputs against the plain
reference, and prints as its last line of standard output one JSON object:
correct, attempted, failed, metrics, device (with --trace 1 also busy_s and
window_s), with --trace 1 a breakdown, and last the numbers compared, each
with its limit. --trace 0 reports the cell's end-to-end metrics, --trace 1
its per-layer metrics from a torch.profiler trace of the window.

It exits non-zero, printing no result, without enough CUDA cards, when a
metric the cell reports cannot be read, or when JAX or the JAX package has
been imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "curve25519_tpu")


def forbidden_modules():
    """The imported modules whose top-level name (the part before the first
    dot) is one of FORBIDDEN."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def cache_dirs():
    """Fixed build and kernel-cache directories inside the checkout."""
    cache = ROOT / "portbench" / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def power_limit_w():
    """Card 0's power limit in watts, or None where nvidia-smi cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def measure(files, benchmark, seed, seconds, trace, device, batch=None,
            check=None, t_start=None):
    """One run of a cell on `device` (a CUDA card, or the CPU in tests):
    set-up, window, reading and check. Returns the result object; its
    `correct` comes from the reference's check of the sampled outputs.
    `batch` and `check` replace the workload's (see harness.Cell)."""
    import torch

    from portbench import harness
    from portbench.harness import log

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    t_inputs = time.perf_counter()
    cell = harness.Cell(files, seed, seconds, trace, device, batch=batch,
                        check=check)
    t_warm = time.perf_counter()
    cell.warm_up()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start - cell.make_s
    log("portbench: %s seed %d set up in %.3f s on %s: %.3f s to here, "
        "inputs pooled and program set-up %.3f s, warm-up %.3f s; the "
        "benchmark made the inputs in %.3f s more"
        % (files.workload_name, seed, setup_s, kind, t_inputs - t_start,
           t_warm - t_inputs - cell.make_s, time.perf_counter() - t_warm,
           cell.make_s))

    gc.collect()
    gc.freeze()                 # set-up's objects: out of the collector's way
    gc.disable()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                   else ProfilerActivity.CPU])
        prof.start()
    try:
        window = files.loop.run(cell)
    finally:
        gc.enable()
        if trace:
            if cuda:
                torch.cuda.synchronize(device)
            prof.stop()
    power_w = power_limit_w() if cuda else None
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": files.workload["chips"],
                   "memory_peak_bytes": torch.cuda.max_memory_allocated(
                       device) if cuda else 0,
                   "power_limit_w": power_w}
    result = {"correct": None, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": {}}
    if trace:
        from portbench import trace as tr
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "window.json")
            prof.export_chrome_trace(path)
            del prof
            events, base_ns = tr.load(path)
            reading = harness.Reading(
                tr.Trace(events, base_ns, cell.span.kept),
                files.deployment.work(files.config, cell.made))
            del events
        log("portbench: %d batches traced; device time launched outside "
            "the benchmark's spans: %.4f%%"
            % (reading.trace.batches, 100 * reading.trace.unattributed()))
        device_info["busy_s"] = reading.trace.busy_s()
        device_info["window_s"] = reading.trace.window_s
        for m in harness.metrics_for(benchmark, files.workload_name,
                                     "per_layer"):
            value = files.metric(m["name"]).read(reading)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
                log("portbench: %s = %r %s (%s, power limit %s W)"
                    % (m["name"], value, m["unit"], kind, power_w))
        result["breakdown"] = reading.trace.breakdown()
    else:
        values = {name: window["metrics"][quantity] for name, quantity
                  in files.workload["report"].items()}
        values["setup_s"] = setup_s
        for m in harness.metrics_for(benchmark, files.workload_name,
                                     "end_to_end"):
            if m["name"] not in values:
                raise KeyError("the cell reports no %s" % m["name"])
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    result["device"] = device_info

    cell.release()
    if cuda:
        torch.cuda.empty_cache()
    result["checks"] = cell.judge()
    result["correct"] = harness.check_passed(result["checks"])
    for k, c in result["checks"].items():
        log("check %s: %s, limit %s" % (k, c["value"], ", ".join(
            "%s %s" % (b, c[b]) for b in ("max", "min") if b in c)))
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    cache_dirs()
    import torch

    from portbench import harness

    files = harness.Files(args.workload)
    chips = files.workload["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        harness.log("portbench: the cell needs %d CUDA card(s); this "
                    "machine has %d" % (chips, have))
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = measure(files, harness.load_json(ROOT / "BENCHMARK.json"),
                     args.seed, args.seconds, args.trace, device,
                     t_start=T_START)
    found = forbidden_modules()
    if found:
        harness.log("portbench: forbidden modules imported: %s"
                    % ", ".join(found))
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
