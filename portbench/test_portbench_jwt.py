"""The EdDSA JWT gateway cell (jwt.batch) on the CPU: its tokens, its frozen
work, the port's CPU route held against the plain reference, and the
correctness check failing where verify_check is broken underneath. The
test marked `cuda` runs the control (results reused across calls) on the
card at the cell's size, on three seeds, with the workload's own sampling:

    python -m pytest portbench/test_portbench_jwt.py -m cuda
"""

import importlib
import json
import subprocess
import sys

import numpy as np
import pytest

from portbench import bound, faults, harness
from portbench.reference import curve

CELL = "jwt.batch"
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def test_tokens_are_signing_inputs_with_each_fault():
    """Signing inputs of base64url characters with one '.' in the header's
    range, lengths even over 200-1,000 bytes, one key, and a sixteenth of
    each batch invalid in four equal kinds, S + L among them; the frozen
    work counts 3-9 SHA-512 blocks a lane and the q_table once."""
    files = harness.Files(CELL)
    n, pool = 128, 2
    made = files.deployment.make(files.config, {"batch": n, "pool": pool},
                                 2**40 + 3)
    sig, msg, msg_len = (made["lanes"][k] for k in ("sig", "msg", "msg_len"))
    alphabet = set(files.deployment.B64URL.tolist()) | {ord(".")}
    for i in range(n * pool):
        live = msg[i, :msg_len[i]].tobytes()
        assert live.count(b".") == 1 or i in made["strata"]["invalid"]
        assert 36 <= live.find(b".") <= 100 or i in made["strata"]["invalid"]
    assert set(np.unique(msg[~np.isin(np.arange(n * pool),
                                      made["strata"]["invalid"])])) \
        <= alphabet
    assert msg_len.min() == 200 and 990 < msg_len.max() <= 1000
    bad, malleated = made["strata"]["invalid"], made["strata"]["malleated"]
    assert len(bad) == pool * n // 16 and len(malleated) == len(bad) // 4
    pk = made["fixed"]["pk"]
    for i in malleated:
        s = int.from_bytes(sig[i, 32:].tobytes(), "little")
        assert curve.L <= s < 2 * curve.L
        good = sig[i].copy()
        good[32:] = np.frombuffer((s - curve.L).to_bytes(32, "little"),
                                  np.uint8)
        m = msg[i, :msg_len[i]].tobytes()
        assert curve.verify(sig[i].tobytes(), pk, m)
        assert not curve.verify(sig[i].tobytes(), pk, m, strict=True)
        assert curve.verify(good.tobytes(), pk, m, strict=True)
    work = files.deployment.work(files.config, made)["verify_check"]
    blocks = sorted(a // bound.SHA_BLOCK_ALU for (_, a), c, _ in work if c)
    assert blocks == list(range(3, 10))
    assert sum(c for _, c, _ in work) == n
    assert work[-1][2] == int(msg_len[:n].sum()) + n * 69 + 2560


def test_port_cpu_route_agrees_with_reference():
    """A tiny batch of the cell through the port's CPU route, every lane
    read by the reference, in a fresh process that then holds no module of
    JAX or of the JAX package."""
    code = """
import json, sys
sys.path.insert(0, %r)
import torch
from portbench import harness, run
bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
files = harness.Files(%r)
every = {k: {"per_batch": 64, "cap": 10**6} for k in files.workload["check"]}
out = run.measure(files, bench, 2**32 + 9, 0.0, 0, torch.device("cpu"),
                  batch=64, check=every)
print(json.dumps({"result": out, "forbidden": run.forbidden_modules()}))
""" % (str(harness.ROOT), CELL)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    res = out["result"]
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["verdict_mismatch"]["value"] == 0
    # every lane, and the invalid and malleated ones once more
    assert res["checks"]["lanes_checked"]["value"] == 64 + 4 + 1
    assert set(res["metrics"]) == {m["name"] for m in harness.metrics_for(
        BENCH, CELL, "end_to_end")} == {"verdicts_per_s", "setup_s"}


def _run(monkeypatch, fault, seed, device, batch=None, seconds=0.0,
         every=True):
    import torch

    from portbench import run
    files = harness.Files(CELL)
    for module, name in files.deployment.API:
        mod = importlib.import_module(module)
        monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    check = ({k: {"per_batch": batch, "cap": 10**6}
              for k in files.workload["check"]} if every else None)
    return run.measure(files, BENCH, seed, seconds, 0, torch.device(device),
                       batch=batch, check=check)


@pytest.mark.parametrize("fault", ["stale", "unchanged", "half", "altered"])
def test_broken_verify_check_is_not_correct(monkeypatch, fault):
    res = _run(monkeypatch, getattr(faults, fault), 2**31 + 3, "cpu",
               batch=48)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["verdict_mismatch"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**33 + 7, 987654321])
def test_control_at_cell_size(monkeypatch, seed):
    """The control on the card at the cell's size and sampling: results
    reused across calls must fail the check."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = _run(monkeypatch, faults.stale, seed, "cuda", seconds=2.0,
               every=False)
    print("control", CELL, seed, res["checks"])
    assert res["correct"] is False, res["checks"]
