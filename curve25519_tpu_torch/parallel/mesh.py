"""Multi-device and multi-process scaling: batch sharding over a 1-D
data-parallel mesh (counterpart of curve25519_tpu/parallel/mesh.py, on
torch.distributed).

Every DH, sign and verify lane is independent, so a batch shards on its
leading axis over the mesh's devices and each shard runs the batched API
on its own device: the hand kernels on a card, the plain versions on the
CPU. The only traffic between processes is the reduction of the throughput
counters (an all_reduce over NCCL between cards, over gloo on the CPU).

A mesh spans `num_processes` processes of `len(devices)` devices each.
Global shard `rank * len(devices) + j` is device `j` of process `rank`
(host-major, the order of the JAX `make_pod_mesh`), and shard `i` holds
rows `[i * B / size, (i + 1) * B / size)` of a global batch of B rows, the
layout of JAX's `P("dp")`.

The device rule of ops/cuda holds: without `devices` a mesh spans the
CUDA cards, and with no card it raises; a caller asks for the CPU by
naming it (`make_mesh(["cpu", "cpu"])`).
"""

import contextlib
import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from curve25519_tpu_torch.models import ed25519, x25519
from curve25519_tpu_torch.ops.cuda import pick_device

__all__ = ["Mesh", "make_mesh", "make_pod_mesh", "shard_batch", "replicate",
           "sharded", "mixed_throughput_step", "init_distributed"]

# how long a rank waits for its peers at the rendezvous and in a collective
# before it raises
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh as one process sees it."""
    devices: tuple          # this process's devices, in shard order
    group: object           # its torch.distributed group (None: one process)
    rank: int
    num_processes: int
    axis_name: str = "dp"

    @property
    def size(self):
        """Shards over all processes."""
        return self.num_processes * len(self.devices)

    def shard_index(self, j):
        """The global shard of local device j."""
        return self.rank * len(self.devices) + j


def make_mesh(devices=None, group=None, axis_name="dp"):
    """Mesh over `devices` of this process (default: every CUDA card it
    sees) in the process group `group` (None: this process alone). Every
    process of the group must give the same number of devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: pass devices=['cpu', ...] to "
                               "run the plain PyTorch versions")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(pick_device(device=d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if group is None:
        return Mesh(devices, None, 0, 1, axis_name)
    return Mesh(devices, group, dist.get_rank(group),
                dist.get_world_size(group), axis_name)


def make_pod_mesh(axis_name="dp", devices=None):
    """Mesh over every process of the default process group, one card each
    (the card init_distributed set, or `devices` of this process); without
    a process group, the single-process mesh over `devices` (default: the
    local cards)."""
    if dist.is_available() and dist.is_initialized():
        return make_mesh(devices or [pick_device()], dist.group.WORLD,
                         axis_name)
    return make_mesh(devices, axis_name=axis_name)


def shard_batch(x, mesh):
    """This process's shards of the global batch x, one per local device,
    each on its device."""
    x = torch.as_tensor(x)
    if x.ndim == 0 or x.shape[0] % mesh.size:
        raise ValueError("a leading axis of %s does not split into %d shards"
                         % (tuple(x.shape), mesh.size))
    rows = x.shape[0] // mesh.size
    first = mesh.shard_index(0)
    return [x[(first + j) * rows:(first + j + 1) * rows].to(d)
            for j, d in enumerate(mesh.devices)]


def _counter_device(mesh):
    """Where the collectives' tensors live: the card for NCCL (and for a
    single process), the CPU for gloo."""
    if mesh.group is not None and dist.get_backend(mesh.group) != "nccl":
        return torch.device("cpu")
    return mesh.devices[0]


def replicate(x, mesh):
    """A copy of x on each local device; across processes the copy is
    rank 0's (every process passes a tensor of the same shape and dtype)."""
    x = torch.as_tensor(x)
    if mesh.group is not None:
        x = x.to(_counter_device(mesh), copy=True)
        dist.broadcast(x, dist.get_global_rank(mesh.group, 0),
                       group=mesh.group)
    return [x.to(d, copy=True) for d in mesh.devices]


def _on(device):
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def sharded(fn, mesh):
    """fn run on each local shard: the returned function takes one list of
    shards per argument (shard_batch's or replicate's) and returns the list
    of per-shard results, or for a tuple-valued fn a tuple of such lists.
    Every protocol op is lane-local, so the shards together give the bytes
    of one call on the global batch. Launches are asynchronous: shards on
    several cards run at once."""
    def run(*shards):
        if any(len(s) != len(mesh.devices) for s in shards):
            raise ValueError("each argument needs one shard per device (%d)"
                             % len(mesh.devices))
        outs = []
        for d, args in zip(mesh.devices, zip(*shards)):
            with _on(d):
                outs.append(fn(*args))
        if isinstance(outs[0], tuple):
            return tuple(list(col) for col in zip(*outs))
        return outs
    return run


def _mixed_shard(sk_a, sk_b, msgs):
    """One shard of the mixed step: (lanes that agreed, shared_a)."""
    a_pk = x25519.calculate_public_key(sk_a)
    b_pk = x25519.calculate_public_key(sk_b)
    s_ab = x25519.create_shared_key(b_pk, sk_a)
    s_ba = x25519.create_shared_key(a_pk, sk_b)
    dh_ok = (s_ab == s_ba).all(-1)

    pk, priv = ed25519.create_keypair(sk_a)
    sigs = ed25519.sign(priv, msgs)
    sig_ok = ed25519.verify(sigs, pk, msgs)
    return dh_ok.sum() + sig_ok.sum(), s_ab


def mixed_throughput_step(mesh):
    """The mixed DH+sign+verify step over the mesh (the BASELINE.json
    config-5 batch). Per shard: two X25519 public keys and both shared
    keys, then an Ed25519 key pair, a signature and its verification.

    Returns fn(sk_a, sk_b, msgs) -> (ok_count, op_count, shared_a): the
    arguments are shard lists (shard_batch), the counters global int64
    scalars (summed over the local shards, then all_reduced over the
    processes; on the card for NCCL, on the CPU for gloo), shared_a this
    process's shards. op_count is 2 * B of the global batch, and so is
    ok_count when every lane agrees and verifies."""
    per_shard = sharded(_mixed_shard, mesh)

    def step(sk_a, sk_b, msgs):
        oks, shared = per_shard(sk_a, sk_b, msgs)
        dev = _counter_device(mesh)
        ops = 2 * sum(s.shape[0] for s in sk_a)
        counts = torch.stack([torch.stack([o.to(dev) for o in oks]).sum(),
                              torch.tensor(ops, device=dev)])
        if mesh.group is not None:
            dist.all_reduce(counts, group=mesh.group)
        return counts[0], counts[1], shared
    return step


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     backend=None, device=None):
    """Join this process to a multi-process run (a no-op for one process).

    coordinator is rank 0's "host:port", where it serves the rendezvous.
    Under torchrun the None arguments come from its environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK). device is
    "cuda" (default: the card LOCAL_RANK, else process_id, modulo the cards
    this process sees), "cuda:N" or "cpu"; a CUDA device is made the
    current card before anything else. backend defaults to "nccl" on a card
    and to "gloo" on the CPU; NCCL without a card raises. A peer that does
    not arrive within TIMEOUT makes the call raise."""
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
        if process_id is None:
            process_id = int(env["RANK"])
        if coordinator is None:
            coordinator = "%s:%s" % (env["MASTER_ADDR"], env["MASTER_PORT"])
    if num_processes is None or num_processes <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("a run of %d processes needs coordinator and "
                         "process_id" % num_processes)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: pass device='cpu' (gloo) to "
                               "run on the CPU")
        if device.index is None:
            local = int(env.get("LOCAL_RANK", process_id))
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("NCCL runs between CUDA cards, not on %s" % device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="tcp://" + coordinator,
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
