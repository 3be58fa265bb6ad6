"""The span recorder of curve25519_tpu_torch/utils/profiling.py on the CPU.

Nesting, parents, work counts and self time; the off path, which keeps
nothing and reads no clock; the X25519 and Ed25519 CPU routes, byte-equal
with recording on and off and recording their API spans around their glue
spans; and a torch.profiler CPU event launched inside a span, which lands
inside it on the trace's clock (baseTimeNanoseconds + ts).

The checks run from
test_torch_x25519.py::test_cpu_tensors_take_the_plain_version_without_launching
through check_recorder, so the number of collected tier-1 tests stays what
it was (an xdist worker's memory maps depend on it: ROADMAP, "Tier-1
hazard"); this module collects no test of its own. Each check ends its own
recording, also when it fails, so a failure stays in this one test. Once
the hazard is repaired, each check becomes a test of its own here.
"""

import glob
import json
import os

import numpy as np
import torch

from curve25519_tpu_torch.models import ed25519, x25519
from curve25519_tpu_torch.utils import profiling


def check_recorder(tmp_path, monkeypatch):
    _check_nesting_and_self_time(monkeypatch)
    _check_off_path_keeps_nothing(monkeypatch)
    _check_cpu_routes_unchanged_by_recording()
    _check_profiler_event_inside_its_span(tmp_path)


def _check_nesting_and_self_time(monkeypatch):
    ticks = iter(range(0, 10**6, 10))
    monkeypatch.setattr("time.time_ns", lambda: next(ticks))

    @profiling.spanned("f", n=len)
    def f():
        with profiling.span("g"):
            pass
        return [1, 2, 3]

    profiling.start_spans()
    try:
        with profiling.span("a", 5):            # 0 .. 70
            with profiling.span("b"):           # 10 .. 20
                pass
            f()                                 # 30 .. 60, g 40 .. 50
        with profiling.span("c"):               # 80 .. (stop) 90
            records = profiling.stop_spans()
    finally:
        profiling.stop_spans()
        monkeypatch.undo()
    assert records == [(0, 70, "a", -1, 5), (10, 20, "b", 0, None),
                       (30, 60, "f", 0, 3), (40, 50, "g", 2, None),
                       (80, 90, "c", -1, None)]
    assert profiling.self_ns(records) == [30, 10, 20, 10, 10]
    assert profiling.stop_spans() == []          # handed out once


def _check_off_path_keeps_nothing(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read with recording off")

    assert not profiling._recording
    monkeypatch.setattr("time.time_ns", no_clock)
    doubled = profiling.spanned("f", n=len)(lambda x: 2 * x)
    assert profiling.span("a") is profiling.span("b", 3)  # one shared no-op
    with profiling.span("a", 3) as sp:
        assert sp is None and doubled([1]) == [1, 1]
    monkeypatch.undo()
    assert profiling._records == [] and profiling._open == []
    assert profiling.stop_spans() == []


def _routes():
    rng = np.random.default_rng(16)
    sk = torch.from_numpy(rng.integers(0, 256, (2, 32), dtype=np.uint8))
    msg = torch.from_numpy(rng.integers(0, 256, (2, 40), dtype=np.uint8))
    pk = x25519.calculate_public_key_fast(sk)
    shared = x25519.create_shared_key(pk.flip(0), sk)
    pub, priv = ed25519.create_keypair(sk)
    sig = ed25519.sign(priv, msg)
    bad = sig.clone()
    bad[1, 5] ^= 1
    ok = ed25519.verify(torch.cat([sig, bad]), pub.repeat(2, 1),
                        msg.repeat(2, 1), torch.tensor([40, 40, 40, 40]))
    return [pk, shared, pub, sig, ok]


def _check_cpu_routes_unchanged_by_recording():
    off = _routes()
    profiling.start_spans()
    try:
        on = _routes()
    finally:
        records = profiling.stop_spans()
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    assert off[4].tolist() == [True, True, True, False]
    top = [(name, n) for _, _, name, parent, n in records if parent < 0]
    assert [t for t in top if "." in t[0] and t[0].split(".")[0] in (
        "x25519", "ed25519")] == [
        ("x25519.calculate_public_key_fast", 2),
        ("x25519.create_shared_key", 2), ("ed25519.sign", 2),
        ("ed25519.verify", 4)]
    names = [r[2] for r in records]

    def children(api):
        i = names.index(api)
        return {r[2] for r in records if r[3] == i}

    assert children("x25519.calculate_public_key_fast") == {
        "codec.clamp", "fold.cut8_bytes"}
    assert children("ed25519.verify") == {
        "ed25519.inputs", "ed25519.digits", "ed25519.verdict"}
    assert children("ed25519.digits") >= {
        "sha512.pack_words", "sc.from_digest", "fold.cut8_bytes",
        "fold.cut4_limbs"}
    # the packing's work count: the bytes of its padded blocks, 4 x 128
    pack = next(r for r in records if r[2] == "sha512.pack_words"
                and records[r[3]][2] == "ed25519.digits")
    assert pack[4] == 4 * 128
    assert all(t0 <= t1 for t0, t1, _, _, _ in records)
    for t0, t1, _, parent, _ in records:
        if parent >= 0:
            assert records[parent][0] <= t0 and t1 <= records[parent][1]


def _check_profiler_event_inside_its_span(tmp_path):
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "spans")) as logdir:
        profiling.start_spans()
        try:
            with profiling.span("mm"):
                torch.mm(x, x)
        finally:
            (t0, t1, name, _, _), = profiling.stop_spans()
    path, = glob.glob(os.path.join(logdir, "*.trace.json"))
    with open(path) as f:
        chrome = json.load(f)
    base = int(chrome["baseTimeNanoseconds"])
    mm, = [e for e in chrome["traceEvents"] if e.get("name") == "aten::mm"]
    start = base + 1000 * mm["ts"]
    assert t0 <= start and start + 1000 * mm["dur"] <= t1
