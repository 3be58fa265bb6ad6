"""The correctness check fails where it must: a run whose timed path is
broken underneath comes out with `correct` false, for the control (results
reused across calls, a guarantee both configurations state) and for each
fault a one-chip cell can have: a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced. (The
exchange between chips does not exist on one chip.)

On the CPU the port's plain route runs tiny batches and the check reads
every lane. The test marked `cuda` runs the control on the card at each
cell's own size, on three seeds, with the workload's own sampling:

    python -m pytest portbench -m cuda
"""

import importlib

import pytest

from portbench import faults, harness

CELLS = {"tls13.batch": 8, "sigverify.padded": 48}
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def _run(monkeypatch, cell, fault, seed, device, batch=None, seconds=0.0,
         every=True):
    import torch

    from portbench import run
    files = harness.Files(cell)
    for module, name in files.deployment.API:
        mod = importlib.import_module(module)
        monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    check = ({k: {"per_batch": batch, "cap": 10**6}
              for k in files.workload["check"]} if every else None)
    return run.measure(files, BENCH, seed, seconds, 0, torch.device(device),
                       batch=batch, check=check)


def _wrong(result):
    return sum(v["value"] for k, v in result["checks"].items()
               if k != "lanes_checked")


@pytest.mark.parametrize("fault", ["stale", "unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_broken_path_is_not_correct(monkeypatch, cell, fault):
    res = _run(monkeypatch, cell, getattr(faults, fault), 2**31 + 3, "cpu",
               batch=CELLS[cell])
    assert res["correct"] is False, res["checks"]
    assert _wrong(res) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**33 + 7, 987654321])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_at_cell_size(monkeypatch, cell, seed):
    """The control on the card at the cell's size and sampling: results
    reused across calls must fail the check."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = _run(monkeypatch, cell, faults.stale, seed, "cuda", seconds=2.0,
               every=False)
    print("control", cell, seed, res["checks"])
    assert res["correct"] is False, res["checks"]
