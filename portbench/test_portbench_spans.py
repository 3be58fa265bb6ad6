"""The program's spans read against a trace, on the CPU: a synthetic window
with program spans gives the expected glue and idle lists and readings, and
leaves every reading of the harness as the plain Trace gives it; the CPU
route of each cell records its spans through run.measure."""

import json
import subprocess
import sys

import pytest

from portbench import bound, harness, spans, trace
from portbench.test_portbench_harness import BENCH, ROOT, _x

BASE = 1_790_000_000_000_000_000                # ns on the wall clock


def _ns(us):
    return BASE + int(1000 * us)


def _harness_spans():
    out = []
    for b in (0, 100):
        out += [(_ns(b), _ns(b + 100), "loop"),
                (_ns(b + 1), _ns(b + 9), "h2d"),
                (_ns(b + 10), _ns(b + 60), "api:verify"),
                (_ns(b + 60), _ns(b + 100), "d2h")]
    return out


# (start us, end us, name, parent, n): the import, a first verify call that
# loads a library, set-up, then two verify batches and a span planted in the
# second batch's d2h
RECORDS = [(-300, -250, "import.curve25519_tpu_torch", -1, None),
           (-200, -100, "ed25519.verify", -1, 4),
           (-190, -150, "build.load_cuda.sha512", 1, None),
           (-50, -40, "build.load_cuda.oneshot", -1, None),
           (-49, -41, "build.nvcc.oneshot", 3, None),
           (-30, -20, "edwards_kernel.mma_word_table", -1, None),
           (-29, -25, "edwards_kernel.word_table", 5, None),
           (11, 57.5, "ed25519.verify", -1, 4),
           (12, 29.5, "ed25519.digits", 7, None),
           (13, 18, "sha512.pack_words", 8, 512),
           (20, 25, "sc.from_digest", 8, None),
           (25.5, 27, "launch.sha512", 8, 4),
           (32, 34.5, "verify_kernel.oneshot_rows", 7, 4),
           (36, 37, "launch.oneshot", 7, 4),
           (40, 45, "ed25519.verdict", 7, None),
           (111, 150, "ed25519.verify", -1, 4),
           (113, 118, "sha512.pack_words", 15, 512),
           (170, 171, "codec.clamp", -1, None)]


def _records():
    return [(_ns(a), _ns(b), name, parent, n)
            for a, b, name, parent, n in RECORDS]


def _events():
    """(launch us, device start us, device end us, category, name) per
    device event, as launch and device events with one correlation id."""
    glue = "void at::native::vectorized_elementwise_kernel<4>()"
    rows = [(2, 3, 8, "gpu_memcpy", "Memcpy HtoD (Pinned -> Device)"),
            (14, 15, 17, "kernel", glue),                  # pack_words
            (21, 22, 24, "kernel", glue),                  # from_digest
            (26, 31, 33, "kernel", "sha512_kernel(int*)"),
            (28, 29, 30, "kernel", glue),                  # digits' cat
            (31, 34, 35, "kernel", glue),                  # verify's own
            (36, 36, 56, "kernel", "oneshot_kernel(int*)"),
            (41, 57, 58, "kernel", glue),                  # verdict
            (61, 62, 64, "gpu_memcpy", "Memcpy DtoH (Device -> Pinned)"),
            (114, 115, 119, "kernel", glue)]               # pack_words
    ev = []
    for corr, (launch, t0, t1, cat, name) in enumerate(rows):
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", launch, 0.5,
                     correlation=corr))
        ev.append(_x(cat, name, t0, t1 - t0, correlation=corr))
    return ev


def _trace(records=None):
    return spans.SpanTrace(_events(), BASE, _harness_spans(),
                           _records() if records is None else records)


def test_program_spans_name_glue_idle_and_batches():
    t = _trace()
    assert t.batches == 2
    assert [(t.program.name[i], b) for i, b in t.top_level()] == [
        ("ed25519.verify", 0), ("ed25519.verify", 1), ("codec.clamp", 1)]
    assert t.outside_api() == 1                 # the planted codec.clamp
    assert dict(t.glue_spans()) == pytest.approx({
        "h2d": 5e-6, "sha512.pack_words": 6e-6, "sc.from_digest": 2e-6,
        "ed25519.digits": 1e-6, "ed25519.verify": 1e-6,
        "ed25519.verdict": 1e-6, "d2h": 2e-6})
    assert dict(t.idle_spans()) == pytest.approx({
        "loop": 3e-6, "h2d": 7e-6, "sha512.pack_words": 5e-6,
        "sc.from_digest": 5e-6, "ed25519.verify": 84e-6,
        "verify_kernel.oneshot_rows": 1e-6, "api:verify": 4e-6,
        "d2h": 51e-6})
    assert t.idle_spans()[0][0] == "ed25519.verify"
    assert t.host_ms(("ed25519.verify",)) == pytest.approx((46.5 + 39) / 2e3)
    assert t.host_ms(("ed25519.sign",)) is None
    assert t.glue_ms(("sha512.pack_words",)) == pytest.approx(6e-3 / 2)
    assert t.glue_ms(spans.DIGITS) == pytest.approx(2e-3 / 2)
    assert t.glue_ms(("fold.cut4_limbs",)) is None
    # the import, the first call beyond the window's median call (100 less
    # the median of 46.5 and 39; its load inside it), loads and tables
    parts = {"import.curve25519_tpu_torch": 50e-6,
             "first_call.ed25519.verify": 57.25e-6,
             "build.load_cuda.oneshot": 10e-6,
             "edwards_kernel.mma_word_table": 10e-6}
    assert t.setup_parts() == pytest.approx(parts)
    assert t.setup_s() == pytest.approx(127.25e-6)
    assert dict(t.setup_spans()) == pytest.approx({
        "import.curve25519_tpu_torch": 50e-6,
        "first_call.ed25519.verify": 57.25e-6,
        "build.load_cuda.sha512": 40e-6,
        "build.load_cuda.oneshot": 10e-6, "build.nvcc.oneshot": 8e-6,
        "edwards_kernel.mma_word_table": 10e-6,
        "edwards_kernel.word_table": 4e-6})
    assert dict(t.warmup_spans()) == pytest.approx({
        "import.curve25519_tpu_torch": 50e-6, "ed25519.verify": 60e-6,
        "build.load_cuda.sha512": 40e-6,
        "build.load_cuda.oneshot": 2e-6, "build.nvcc.oneshot": 8e-6,
        "edwards_kernel.mma_word_table": 6e-6,
        "edwards_kernel.word_table": 4e-6})
    assert spans.host_ms_a_call(_records(), 1) == pytest.approx(
        {"ed25519.verify": 42.75e-3})
    # the work counts: lanes of verify and of its launches, bytes packed
    assert {k: v for k, *v in t.work_spans()} == {
        "ed25519.verify": [4, pytest.approx(85.5e3 / 8),
                           pytest.approx(33e3 / 8)],
        "sha512.pack_words": [512, pytest.approx(10e3 / 1024),
                              pytest.approx(6e3 / 1024)],
        "launch.sha512": [2, pytest.approx(375), pytest.approx(500)],
        "verify_kernel.oneshot_rows": [2, pytest.approx(625), 0.0],
        "launch.oneshot": [2, pytest.approx(250), pytest.approx(5000)]}
    host = dict(t.host_spans())
    assert host["launch.oneshot"] == pytest.approx(1e-6)
    assert host["ed25519.verify"] == pytest.approx(
        (46.5 - 17.5 - 2.5 - 1 - 5 + 39 - 5) * 1e-6)
    assert t.coverage() == {"ed25519.verify": [pytest.approx(11e-6),
                                               pytest.approx(10 / 11)]}
    report = t.report("sigverify.padded")
    assert set(report["metrics"]) == {
        "api.host_ms.sigverify", "glue.pack_ms.sigverify",
        "glue.digits_ms.sigverify", "setup.program_s"}
    assert report["metrics"]["setup.program_s"] == {
        "value": pytest.approx(127.25e-6), "unit": "s"}
    assert report["work_spans"] == t.work_spans()
    # no x25519 or sign span: of the TLS cell's, packing and set-up read
    assert set(t.report("tls13.batch")["metrics"]) == {
        "glue.pack_ms.tls13", "setup.program_s"}


def test_innermost_span_is_an_ancestor_of_the_last_begun():
    p = spans.ProgramSpans(_records(), BASE)
    name = [None if i < 0 else p.name[i] for i in (
        p.at(-45e-6), p.at(-35e-6), p.at(16e-6), p.at(19e-6),
        p.at(30e-6), p.at(58e-6), p.at(0.0), p.at(-160e-6))]
    assert name == ["build.nvcc.oneshot", None, "sha512.pack_words",
                    "ed25519.digits", "ed25519.verify", None, None,
                    "build.load_cuda.sha512"]


def test_events_with_one_start_and_name_keep_their_launches():
    """Two device events with the same start, end and name, launched from
    different program spans, are each put down to their own span."""
    glue = "void at::native::vectorized_elementwise_kernel<4>()"
    ev = []
    for corr, launch in enumerate((14, 21)):
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", launch, 0.5,
                     correlation=corr))
        ev.append(_x("kernel", glue, 40, 1, correlation=corr))
    t = spans.SpanTrace(ev, BASE, _harness_spans(), _records())
    assert [t.program.name[e["program"]] for e in t.events] == [
        "sha512.pack_words", "sc.from_digest"]


def test_joined_moves_the_parents():
    before = [(0, 9, spans.IMPORT, -1, None)]
    assert spans.joined(before, [(10, 20, "a", -1, 2), (11, 12, "b", 0,
                                                         None)]) == [
        (0, 9, spans.IMPORT, -1, None), (10, 20, "a", -1, 2),
        (11, 12, "b", 1, None)]


def _readings(t):
    work = {call: [((bound.Counter(), 0), 0, 1e3)]
            for call in ("create_shared_key", "sign", "verify")}
    reading = harness.Reading(t, work)
    files = harness.Files("tls13.batch")
    return {m["name"]: files.metric(m["name"]).read(reading)
            for m in BENCH["per_layer"]}


@pytest.mark.parametrize("records", ["with", "without"])
def test_harness_readings_are_unchanged(records):
    """The seven per-layer readings, the breakdown and the unattributed
    share are the plain Trace's, with program spans and without."""
    plain = trace.Trace(_events(), BASE, _harness_spans())
    t = _trace(None if records == "with" else [])
    assert len(_readings(plain)) == 7
    assert _readings(t) == _readings(plain)
    assert t.breakdown() == plain.breakdown()
    assert t.unattributed() == plain.unattributed()
    if records == "without":
        assert t.report("sigverify.padded")["metrics"] == {}
        assert dict(t.glue_spans()) == pytest.approx({
            "h2d": 5e-6, "api:verify": 11e-6, "d2h": 2e-6})


def test_cpu_route_records_the_program_spans():
    """A tiny batch of each cell through run.measure on the port's CPU
    route with spans recorded: its API spans lie in the harness's api spans
    of their batches, set-up is recorded, and the run stays correct."""
    code = """
import json, sys
sys.path.insert(0, %r)
import torch
from curve25519_tpu_torch.utils import profiling
from portbench import harness, run, spans
bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
out = {}
for cell, batch in (("tls13.batch", 4), ("sigverify.padded", 8)):
    files = harness.Files(cell)
    with spans.recorded(profiling) as kept:
        res = run.measure(files, bench, 2**33 + 5, 0.0, 1,
                          torch.device("cpu"), batch=batch)
    res["spans"] = kept["trace"].report(cell)
    res["recording"] = profiling._recording
    out[cell] = res
out["forbidden"] = run.forbidden_modules()
print(json.dumps(out))
""" % str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out.pop("forbidden") == []
    batch = {"tls13.batch": 4, "sigverify.padded": 8}
    api = {"tls13.batch": ("api.host_ms.tls13", spans.TLS_API),
           "sigverify.padded": ("api.host_ms.sigverify",
                                ("ed25519.verify",))}
    for cell, res in out.items():
        assert res["correct"] is True and res["recording"] is False
        s = res["spans"]
        assert s["outside_api"] == 0 and s["spans_kept"] > 0
        metric, names = api[cell]
        assert s["metrics"][metric]["value"] > 0
        host = dict(s["host_spans"])
        assert set(names) | {"sha512.pack_words"} <= set(host)
        lanes = {k: u for k, u, _, _ in s["work_spans"]}
        assert [lanes[k] for k in names] == [batch[cell]] * len(names)
    # the static Z-randomizer is made at the first sign, in the first cell
    tls = out["tls13.batch"]["spans"]
    assert "blinding.static_zr" in dict(tls["setup_spans"])
    assert tls["metrics"]["setup.program_s"]["value"] > 0
