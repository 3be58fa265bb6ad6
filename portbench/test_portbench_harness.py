"""The harness on the CPU: files found by name, new files added without an
edit, the port's CPU route held against the reference, the exits without a
card, the modules a run imports, and the trace reading."""

import json
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import bound, harness, trace

ROOT = harness.ROOT
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_follows_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert harness.load_json(ROOT / c["file"])["reduced"] == c["reduced"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert (harness.HERE / "metrics" / (m["name"] + ".py")).is_file()
    for w in BENCH["workloads"]:
        # setup_s, another end-to-end metric and a per-layer one in every
        # cell; a per-layer metric only where the metric it moves is
        reported = {m["name"] for m in harness.metrics_for(
            BENCH, w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        layer = harness.metrics_for(BENCH, w["name"], "per_layer")
        assert layer and all(m["moves"] in reported for m in layer)
        report = harness.Files(w["name"]).workload["report"]
        assert set(report) | {"setup_s"} == reported
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for n in names + [w["name"] for w in BENCH["workloads"]]:
        assert NAME.match(n)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_workload_resolves_by_name(cell):
    """Each cell's workload file names its config, deployment, reference
    and loop, and BENCHMARK.json agrees with it; each of its per-layer
    metrics has a reader."""
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    files = harness.Files(cell)
    assert files.workload["config"] == entry["config"]
    assert files.workload["traffic"]["name"] == entry["traffic"]
    assert files.workload["chips"] == entry["chips"]
    assert files.workload["why"] == entry["why"]
    for fn in ("make", "setup", "run_batch", "work"):
        assert callable(getattr(files.deployment, fn))
    assert callable(files.reference.judge) and callable(files.loop.run)
    layer = harness.metrics_for(BENCH, cell, "per_layer")
    assert layer
    for m in layer:
        assert callable(files.metric(m["name"]).read)


def _measure(files, benchmark, seed, trace_on, batch, **kw):
    import torch

    from portbench import run
    return run.measure(files, benchmark, seed, 0.0, trace_on,
                       torch.device("cpu"), batch=batch, **kw)


def test_port_cpu_route_agrees_with_reference():
    """A tiny batch of each cell through the port's CPU route, every lane
    read by the reference, in a fresh process that then holds no module of
    JAX or of the JAX package."""
    code = """
import json, sys
sys.path.insert(0, %r)
import torch
from portbench import harness, run
bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
out = {}
for cell, batch in (("tls13.batch", 8), ("sigverify.padded", 32)):
    files = harness.Files(cell)
    every = {k: {"per_batch": batch, "cap": 10**6}
             for k in files.workload["check"]}
    out[cell] = run.measure(files, bench, 2**32 + 7, 0.0, 0,
                            torch.device("cpu"), batch=batch, check=every)
out["forbidden"] = run.forbidden_modules()
print(json.dumps(out))
""" % str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out.pop("forbidden") == []
    for cell, res in out.items():
        assert res["correct"] is True, (cell, res["checks"])
        assert res["checks"]["lanes_checked"]["value"] >= 8
        assert all(v["value"] == 0 for k, v in res["checks"].items()
                   if k != "lanes_checked")
        assert set(res["metrics"]) == {m["name"] for m in
                                       harness.metrics_for(BENCH, cell,
                                                           "end_to_end")}
        assert list(res)[-1] == "checks"


def test_new_cell_and_metric_are_files_only(tmp_path):
    """A copy of the benchmark gains a workload file and a metric file, and
    its BENCHMARK.json their entries; the harness runs the new cell and
    reads the new metric with no other file changed."""
    root = tmp_path / "portbench"
    shutil.copytree(harness.HERE, root, ignore=shutil.ignore_patterns(
        "_cache", "__pycache__"))
    (root / "workloads" / "tls13.tiny.json").write_text(json.dumps({
        "config": "tls13_x25519_ed25519", "loop": "closed", "chips": 1,
        "traffic": {"name": "tiny", "batch": 4, "pool": 2},
        "report": {"handshakes_per_s": "ops_per_s"},
        "check": {"all": {"per_batch": 4, "cap": 100}},
        "why": "a test cell"}))
    (root / "metrics" / "loop.batches.py").write_text(
        "def read(reading):\n    return reading.trace.batches\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "tls13.tiny",
                               "config": "tls13_x25519_ed25519",
                               "traffic": "tiny", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({
        "name": "loop.batches", "unit": "batches", "better": "higher",
        "source": "program_counter", "layer": "loop",
        "moves": "handshakes_per_s",
        "workloads": ["tls13.tiny"]})
    res = _measure(harness.Files("tls13.tiny", root=root), bench, 3, 1, None)
    assert res["correct"] is True, res["checks"]
    assert res["metrics"] == {"loop.batches": {"value": 1,
                                               "unit": "batches"}}
    assert res["attempted"] == 4


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_pooled_batches_are_distinct(cell):
    """The pool's batches hold no lane twice (a cache keyed on a lane's
    inputs finds nothing within the pool's first round), every batch has
    the same set of lengths, and the sampler maps a batch's rows back to
    the made lanes of its stratum."""
    files = harness.Files(cell)
    n, pool = 8 if cell.startswith("tls13") else 48, 3
    made = files.deployment.make(files.config, {"batch": n, "pool": pool},
                                 2**32 + 21)
    lanes = made["lanes"]
    assert made["batch"] == n
    assert all(len(v) == n * pool for v in lanes.values())
    rows = {b"".join(lanes[k][i].tobytes() for k in sorted(lanes))
            for i in range(n * pool)}
    assert len(rows) == n * pool
    for k, v in lanes.items():
        if v.ndim == 1:
            assert all(sorted(v[p * n:(p + 1) * n]) == sorted(v[:n])
                       for p in range(pool))
    strata = made["strata"]
    sampler = harness.Sampler(strata, {k: {"per_batch": n, "cap": 10**6}
                                       for k in strata}, pool, n, 5)
    for p in range(pool):
        sampler.take(p, {"row": np.arange(n)})
    for name, lane_set in strata.items():
        got, outs = sampler.kept[name]
        got = np.concatenate(got)
        assert np.array_equal(got % n, np.concatenate(outs["row"]))
        if lane_set is not None:
            assert set(got) == set(lane_set)


def _run_py(cwd, env_extra=None):
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tls13.batch",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_exits_nonzero_without_a_card():
    proc = _run_py(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    proc = _run_py(tmp_path, {"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from portbench import run
    for name in ("jax", "jax.numpy", "curve25519_tpu", "curve25519_tpu.ops",
                 "flax", "jaxlib.xla"):
        monkeypatch.setitem(sys.modules, name, object())
    found = run.forbidden_modules()
    assert "curve25519_tpu_torch" not in found
    assert {"jax", "jax.numpy", "curve25519_tpu", "curve25519_tpu.ops",
            "flax", "jaxlib.xla"} <= set(found)


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_trace_attribution_union_and_gaps():
    """Device events go to the span their launch was in; busy time is a
    union (overlaps count once); gaps are named by the host's span."""
    base = 1_790_000_000_000_000_000            # ns on the wall clock

    def span(name, t0, dur):                    # trace us -> wall ns
        return (base + 1000 * t0, base + 1000 * (t0 + dur), name)

    spans = [span("loop", 0, 100), span("h2d", 1, 9),
             span("api:create_shared_key", 10, 10), span("d2h", 20, 80),
             span("loop", 100, 100), span("api:create_shared_key", 110, 10)]
    ev = [_x("cuda_runtime", "cudaMemcpyAsync", 2, 1, correlation=1),
          _x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=2),
          _x("cuda_runtime", "cudaLaunchKernel", 14, 1, correlation=3),
          _x("cuda_runtime", "cudaLaunchKernel", 112, 1, correlation=4),
          _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 3, 6,
             correlation=1),
          _x("kernel", "x25519_ladder_kernel(unsigned char*)", 15, 40,
             correlation=2),
          _x("kernel", "void at::native::vectorized_elementwise_kernel<4>()",
             30, 10, correlation=3),
          _x("kernel", "x25519_ladder_kernel(unsigned char*)", 115, 45,
             correlation=4)]
    t = trace.Trace(ev, base, spans)
    assert t.batches == 2 and t.window_s == pytest.approx(200e-6)
    assert t.seconds(glue=False, span="api:create_shared_key") == \
        pytest.approx(85e-6)
    assert t.seconds(glue=True) == pytest.approx(16e-6)
    assert t.busy_s() == pytest.approx((6 + 40 + 45) * 1e-6)
    gaps = dict((k, v) for k, v in t.breakdown()["idle_gaps"])
    assert gaps == pytest.approx({"loop": 43e-6, "h2d": 6e-6, "d2h": 60e-6})
    ops = dict(t.breakdown()["device_ops"])
    assert ops["x25519_ladder_kernel"] == pytest.approx(85e-6)
    assert "at::native::vectorized_elementwise_kernel<4>" in ops
    work = {"create_shared_key": [((bound.Counter(), 0), 0,
                                   bound.HBM_BYTES_PER_S * 85e-6 / 2 * 0.5)]}
    reading = harness.Reading(t, work)
    assert reading.roofline("create_shared_key") == pytest.approx(50.0)
    assert reading.glue_ms() == pytest.approx(16e-3 / 2)
    assert reading.idle_pct() == pytest.approx(100 * (1 - 91 / 200))
    assert reading.roofline("sign") is None
    assert t.unattributed() == pytest.approx(0.0)
