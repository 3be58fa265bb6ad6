"""Sustained-throughput signing loop on the PyTorch port: keep the cards
busy with overlapped dispatch (kernel launches are asynchronous: enqueue the
next batch while the previous one computes), shard over every card of the
mesh, and report an aggregate counter (the port's counterpart of
examples/throughput_server.py).

Run from the repo root:
    python examples/torch_throughput_server.py [seconds] [--device cpu]
    torchrun --nproc-per-node=N examples/torch_throughput_server.py [seconds]

One process shards over the cards it sees; under torchrun each process
takes one card (parallel.mesh.init_distributed reads torchrun's
environment) and the counters are summed over the processes. `--device cpu`
runs the plain PyTorch versions on a small batch.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _wait(shards):
    for s in shards:
        s[0, 0].item()                      # host fetch = sync barrier


def main(duration_s, device):
    import torch
    import torch.distributed as dist
    from curve25519_tpu_torch.models import ed25519
    from curve25519_tpu_torch.parallel import mesh as pmesh
    from curve25519_tpu_torch.utils.profiling import Counter

    cuda = torch.device(device).type == "cuda"
    pmesh.init_distributed(device=device)    # a no-op outside torchrun
    m = pmesh.make_pod_mesh(devices=None if cuda else [device])
    B = (16384 if cuda else 4) * m.size
    if m.rank == 0:
        print(f"mesh: {m.num_processes} process(es) x {len(m.devices)} "
              f"device(s), batch {B}")

    rng = np.random.default_rng(0)
    seed = pmesh.shard_batch(rng.integers(0, 256, (B, 32), dtype=np.uint8), m)
    msg = pmesh.shard_batch(rng.integers(0, 256, (B, 64), dtype=np.uint8), m)

    keypair = pmesh.sharded(ed25519.create_keypair, m)
    sign = pmesh.sharded(ed25519.sign, m)

    pk, priv = keypair(seed)
    _wait(sign(priv, msg))                  # warm: build and load kernels

    # steady state: keep >= 2 batches in flight; sync on the oldest result
    c = Counter("ed25519_sign")
    local = sum(s.shape[0] for s in msg)
    inflight = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < duration_s:
        inflight.append(sign(priv, msg))
        if len(inflight) >= 2:
            _wait(inflight.pop(0))
            c.add(local, 0.0)
    for r in inflight:
        _wait(r)
        c.add(local, 0.0)
    c.seconds = time.perf_counter() - t0

    if m.group is not None:                 # sum the ops, the slowest wall
        dev = m.devices[0] if dist.get_backend(m.group) == "nccl" else "cpu"
        ops = torch.tensor([c.ops], dtype=torch.int64, device=dev)
        secs = torch.tensor([c.seconds], dtype=torch.float64, device=dev)
        dist.all_reduce(ops, group=m.group)
        dist.all_reduce(secs, op=dist.ReduceOp.MAX, group=m.group)
        c.ops, c.seconds = int(ops), float(secs)
        dist.destroy_process_group()
    if m.rank == 0:
        print(c.json())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seconds", nargs="?", type=float, default=10.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (plain versions)")
    args = ap.parse_args()
    main(args.seconds, args.device)
