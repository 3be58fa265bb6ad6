"""One process of an N-process torch.distributed run of the port's mesh
(the counterpart of tests/mp_worker.py; it imports no jax).

    python tests/torch_mp_worker.py <process_id> <num_processes> <port>
        <devs_per_proc> [--device cpu|cuda] [--lanes B] [--msg-len L]
        [--out DIR]

It joins the run through curve25519_tpu_torch.parallel.mesh.init_distributed
(gloo), builds the pod mesh, shards a global batch of B lanes made by
inputs() and runs mixed_throughput_step. Both all_reduced counters must be
2 * B. It writes its shared_a shards to DIR/shared_<global shard>.npy and
prints 'TORCH_MP_OK ok=N ops=N procs=P devs=D'. On the CPU each process
holds devs_per_proc devices; on a card it holds the card init_distributed
set (devs_per_proc must be 1)."""

import argparse
import os
import sys

import numpy as np


def inputs(lanes, msg_len):
    """(sk_a, sk_b, msgs) of the global batch, from default_rng(9) as in
    tests/mp_worker.py."""
    rng = np.random.default_rng(9)
    sk_a = rng.integers(0, 256, (lanes, 32), dtype=np.uint8)
    sk_b = rng.integers(0, 256, (lanes, 32), dtype=np.uint8)
    msgs = rng.integers(0, 256, (lanes, msg_len), dtype=np.uint8)
    return sk_a, sk_b, msgs


def main():
    ap = argparse.ArgumentParser()
    for name in ("process_id", "num_processes", "port", "devs_per_proc"):
        ap.add_argument(name, type=int)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--msg-len", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    import torch.distributed as dist
    from curve25519_tpu_torch.parallel import mesh as pmesh

    pmesh.init_distributed(coordinator="127.0.0.1:%d" % args.port,
                           num_processes=args.num_processes,
                           process_id=args.process_id, backend="gloo",
                           device=args.device)
    if args.device == "cpu":
        m = pmesh.make_pod_mesh(devices=["cpu"] * args.devs_per_proc)
    else:
        m = pmesh.make_pod_mesh()
    if (m.num_processes, m.rank, len(m.devices)) != (
            args.num_processes, args.process_id, args.devs_per_proc):
        raise SystemExit("mesh %s does not match the arguments" % (m,))

    step = pmesh.mixed_throughput_step(m)
    batch = [pmesh.shard_batch(x, m) for x in inputs(args.lanes,
                                                     args.msg_len)]
    ok, ops, shared = step(*batch)
    ok, ops = int(ok), int(ops)
    if ops != 2 * args.lanes or ok != ops:
        raise SystemExit("counters ok=%d ops=%d, expected %d"
                         % (ok, ops, 2 * args.lanes))
    if args.out:
        for j, s in enumerate(shared):
            np.save(os.path.join(args.out, "shared_%d.npy"
                                 % m.shard_index(j)), s.cpu().numpy())
    bad = [k for k in sys.modules
           if k == "jax" or k.startswith("jax.")
           or k.split(".")[0] == "curve25519_tpu"]
    if bad:
        raise SystemExit("the port imported %s" % bad[:3])
    print("TORCH_MP_OK ok=%d ops=%d procs=%d devs=%d"
          % (ok, ops, m.num_processes, m.size), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
