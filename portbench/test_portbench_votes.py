"""The Solana vote sigverify cell (votes.cached) on the CPU: its votes, its
frozen work, the port's CPU route held against the plain reference, and the
correctness check failing where verify_cached is broken underneath. The
test marked `cuda` runs the control (results reused across calls) on the
card at the cell's size, on three seeds, with the workload's own sampling:

    python -m pytest portbench/test_portbench_votes.py -m cuda
"""

import importlib
import json
import subprocess
import sys

import numpy as np
import pytest

from portbench import bound, faults, harness
from portbench.reference import curve

CELL = "votes.cached"
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
# a small staked set, so that the CPU's plain Verify_Init of it is quick,
# and more misses, so that a tiny batch holds some
SMALL = {"staked_keys": 12, "unstaked_keys": 3, "miss_one_in": 8}


def test_votes_are_signed_by_staked_and_unstaked_keys():
    """Vote lengths even over 220-330 bytes; each staked key signs in turn
    (as many votes a batch, to within one), the misses by keys outside the
    staked set; a sixteenth of each batch invalid; the frozen work counts
    3-4 SHA-512 blocks a lane, the multiply for the staked signers' lanes,
    one-shot verification for the others and the q_tables once."""
    files = harness.Files(CELL)
    config = dict(files.config, **SMALL)
    n, pool = 128, 2
    made = files.deployment.make(config, {"batch": n, "pool": pool},
                                 2**40 + 5)
    sig, pk, msg, msg_len = (made["lanes"][k]
                             for k in ("sig", "pk", "msg", "msg_len"))
    staked = made["fixed"]["staked"]
    assert staked.shape == (12, 32)
    assert msg_len.min() == 220 and 325 < msg_len.max() <= 330
    miss, bad = made["strata"]["miss"], made["strata"]["invalid"]
    assert len(miss) == pool * (n // 8) and len(bad) == pool * (n // 16)
    cached = (pk[:, None] == staked[None]).all(-1)
    assert not cached[miss].any()
    hit = np.setdiff1d(np.arange(n * pool), miss)
    assert cached[hit].sum(1).tolist() == [1] * len(hit)
    for p in range(pool):
        lanes = hit[(hit >= p * n) & (hit < (p + 1) * n)]
        counts = np.bincount(cached[lanes].argmax(1), minlength=12)
        assert np.ptp(counts) <= 1
    assert len({pk[i].tobytes() for i in miss}) == 3
    for i in range(n * pool):
        want = curve.verify(sig[i].tobytes(), pk[i].tobytes(),
                            msg[i, :msg_len[i]].tobytes())
        assert want == (i not in bad), i
    work = files.deployment.work(config, made)["verify_cached"]
    blocks = sorted({a // bound.SHA_BLOCK_ALU for (_, a), c, _ in work if c})
    assert blocks == [3, 4]
    assert sum(c for _, c, _ in work) == n
    one_shot = sum(c for (f, _), c, _ in work
                   if c and f == bound.verify_ops(3)[0])
    assert one_shot == n // 8
    assert work[-1][2] == int(msg_len[:n].sum()) + n * 101 + 12 * 2560


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
files.config.update(%r)
every = {k: {"per_batch": 64, "cap": 10**6} for k in files.workload["check"]}
out = run.measure(files, bench, 2**32 + 9, 0.0, 0, torch.device("cpu"),
                  batch=64, check=every)
print(json.dumps({"result": out, "forbidden": run.forbidden_modules()}))
""" % (str(harness.ROOT), CELL, SMALL)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    res = out["result"]
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["verdict_mismatch"]["value"] == 0
    # every lane, and the invalid and missed ones once more
    assert res["checks"]["lanes_checked"]["value"] == 64 + 4 + 8
    assert set(res["metrics"]) == {m["name"] for m in harness.metrics_for(
        BENCH, CELL, "end_to_end")} == {"verdicts_per_s", "setup_s"}


def _run(monkeypatch, fault, seed, device, batch=None, seconds=0.0,
         every=True, config=()):
    import torch

    from portbench import run
    files = harness.Files(CELL)
    files.config.update(config)
    for module, name in files.deployment.API:
        mod = importlib.import_module(module)
        monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    check = ({k: {"per_batch": batch, "cap": 10**6}
              for k in files.workload["check"]} if every else None)
    return run.measure(files, BENCH, seed, seconds, 0, torch.device(device),
                       batch=batch, check=check)


@pytest.mark.parametrize("fault", ["stale", "unchanged", "half", "altered"])
def test_broken_verify_cached_is_not_correct(monkeypatch, fault):
    res = _run(monkeypatch, getattr(faults, fault), 2**31 + 3, "cpu",
               batch=48, config=SMALL)
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
