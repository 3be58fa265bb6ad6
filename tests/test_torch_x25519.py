"""The port's X25519 slice against the JAX package's, byte for byte.

On the CPU, curve25519_tpu_torch.models.x25519 routes to the plain ladder
(models/montgomery.point_multiply); the JAX side runs its own CPU path
through a module-level jax.jit wrapper (an eager JAX ladder costs 10-30 s).
Inputs come from a seeded numpy generator and go to both packages. Tolerance:
exact bytes. The kernel itself is held against the plain version on the
card by tests/test_torch_cuda.py.

The OO wrapper (oo.py) on both of its routes (the batched API with
device="cpu", and the port's host core with native=True) gives the bytes of
the JAX package's classes on their host core (native=True, no XLA). The
launch counters' Counter, timed and trace of utils/profiling are held
against the JAX package's JSON and against a CPU op.

The mesh (parallel/mesh.py) is held against the same JAX bytes: sharded
calculate_public_key over four CPU devices, and the mixed step of two
gloo processes of two CPU devices each (tests/torch_mp_worker.py, the
counterpart of tests/test_multiprocess.py).
"""

import functools
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from curve25519_tpu import oo as joo
from curve25519_tpu import refmodel
from curve25519_tpu.config import P
from curve25519_tpu.models import x25519 as jx25519
from curve25519_tpu.utils import profiling as jprofiling

from curve25519_tpu_torch import oo
from curve25519_tpu_torch.config import int_to_limbs
from curve25519_tpu_torch.models import montgomery, x25519
from curve25519_tpu_torch.ops.cuda import ladder_kernel
from curve25519_tpu_torch.parallel import mesh as pmesh
from curve25519_tpu_torch.utils import interop, profiling
from curve25519_tpu_torch.utils.interop import to_numpy

from test_torch_ladder_host import jax_host_core
from test_torch_profiling import check_recorder
from torch_mp_worker import inputs as mp_inputs

# the carriers default to the card: these tests ask for the CPU
from_numpy = functools.partial(interop.from_numpy, device="cpu")

REPO = Path(__file__).resolve().parents[1]
BATCH = 16

# RFC 7748 5.2 and 6.1 vectors (tests/test_x25519.py)
V1_K = "a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4"
V1_U = "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c"
V1_OUT = "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"
V2_K = "4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d"
V2_U = "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493"
V2_OUT = "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"
A_SK = "77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a"
A_PK = "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"
B_SK = "5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb"
B_PK = "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"
SHARED = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"

# benchmarks/tpu_vectors.py x25519_edge_u
EDGE_U = [0, 1, P, P + 1, 2**255 - 1, 1 | 1 << 255]

# One compiled JAX ladder serves both API functions: on the CPU the JAX
# calculate_public_key is create_shared_key's ladder from u = 9
# (curve25519_tpu/models/x25519.py), and each distinct jit costs ~30 s here.
_jax_shared = jax.jit(jx25519.create_shared_key)


@pytest.fixture(scope="module", autouse=True)
def _free_xla_executables():
    jax.clear_caches()
    yield
    jax.clear_caches()


def hx(*hexes):
    return torch.tensor([list(bytes.fromhex(h)) for h in hexes],
                        dtype=torch.uint8)


@pytest.fixture
def rng():
    return np.random.default_rng(7748)


def hexes(t):
    return [bytes(r).hex() for r in to_numpy(t).reshape(-1, 32)]


def rand_bytes(rng, n):
    return rng.integers(0, 256, (n, 32), dtype=np.uint8)


def test_slice_equals_jax(rng, tmp_path):
    """calculate_public_key and create_shared_key on one batch, plus rank-1
    and broadcast calls, against the JAX functions' bytes; the same through
    the mesh."""
    sk_a, sk_b, peer = (rand_bytes(rng, BATCH) for _ in range(3))
    base = np.zeros((BATCH, 32), np.uint8)
    base[:, 0] = 9
    pk_a_j = np.asarray(_jax_shared(base, sk_a))
    pk_a = x25519.calculate_public_key(from_numpy(sk_a))
    np.testing.assert_array_equal(to_numpy(pk_a), pk_a_j)

    shared_j = np.asarray(_jax_shared(peer, sk_b))
    shared = x25519.create_shared_key(from_numpy(peer), from_numpy(sk_b))
    assert shared.dtype == torch.uint8 and shared.shape == (BATCH, 32)
    np.testing.assert_array_equal(to_numpy(shared), shared_j)

    # rank-1 call == its batch row
    row = x25519.create_shared_key(from_numpy(peer[3]), from_numpy(sk_b[3]))
    assert row.shape == (32,)
    np.testing.assert_array_equal(to_numpy(row), shared_j[3])
    # one peer broadcast over the batch of keys, against JAX on the same
    # (explicitly broadcast) inputs
    bcast = x25519.create_shared_key(from_numpy(peer[0]), from_numpy(sk_b))
    want = np.asarray(_jax_shared(np.broadcast_to(peer[0], peer.shape), sk_b))
    np.testing.assert_array_equal(to_numpy(bcast), want)
    for route in ({"device": "cpu"}, {"native": True}):
        _check_oo_equals_jax_host_core(rng, route)
    _check_mesh_sharded_equals_jax(sk_a, pk_a_j)
    _check_two_process_gloo_step(base, tmp_path)


def _check_mesh_sharded_equals_jax(sk, pk_j):
    """shard_batch and sharded(calculate_public_key) over four CPU devices:
    the shards in mesh order are the JAX bytes. An indivisible batch raises,
    replicate copies to every device, and make_pod_mesh without a process
    group is a mesh of this process alone."""
    m = pmesh.make_mesh(["cpu"] * 4)
    assert (m.size, m.num_processes, m.rank, m.group) == (4, 1, 0, None)
    shards = pmesh.shard_batch(sk, m)
    assert [s.shape for s in shards] == [(BATCH // 4, 32)] * 4
    pk = pmesh.sharded(x25519.calculate_public_key, m)(shards)
    np.testing.assert_array_equal(to_numpy(torch.cat(pk)), pk_j)
    with pytest.raises(ValueError, match="does not split"):
        pmesh.shard_batch(sk[:BATCH - 1], m)
    with pytest.raises(ValueError, match="one shard per device"):
        pmesh.sharded(x25519.calculate_public_key, m)(shards[:3])
    copies = pmesh.replicate(from_numpy(sk[0]), m)
    assert len(copies) == 4
    assert all(torch.equal(c, from_numpy(sk[0])) for c in copies)
    assert len({c.data_ptr() for c in copies}) == 4
    pod = pmesh.make_pod_mesh(devices=["cpu", "cpu"])
    assert (pod.size, pod.num_processes, pod.group) == (2, 1, None)
    if not torch.cuda.is_available():
        # no devices named and no card: raise, never a CPU mesh
        for make in (pmesh.make_mesh, pmesh.make_pod_mesh):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                make()
        with pytest.raises(RuntimeError, match="no CUDA card"):
            pmesh.init_distributed("127.0.0.1:1", 2, 0, backend="nccl")
    with pytest.raises(ValueError, match="NCCL"):
        pmesh.init_distributed("127.0.0.1:1", 2, 0, backend="nccl",
                               device="cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _check_two_process_gloo_step(base, out):
    """Two processes of two CPU devices each join over gloo
    (init_distributed, make_pod_mesh) and run mixed_throughput_step on 8
    global lanes: both all_reduced counters are 16 on each rank, and the
    shared_a shards, put together, are the JAX create_shared_key(
    calculate_public_key(sk_b), sk_a) bytes."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_mp_worker.py"),
         str(pid), "2", str(port), "2", "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    joined = "\n---\n".join(outs)
    assert all(p.returncode == 0 for p in procs), joined
    assert all("TORCH_MP_OK ok=16 ops=16 procs=2 devs=4" in o
               for o in outs), joined
    got = np.concatenate([np.load(out / ("shared_%d.npy" % i))
                          for i in range(4)])
    # the JAX ladder at BATCH lanes (its one compile): 8 lanes, zero-padded
    sk_a, sk_b, _ = mp_inputs(8, 16)
    pad = np.zeros((BATCH - 8, 32), np.uint8)
    pk_b = np.asarray(_jax_shared(base, np.concatenate([sk_b, pad])))
    want = np.asarray(_jax_shared(pk_b, np.concatenate([sk_a, pad])))[:8]
    np.testing.assert_array_equal(got, want)


def _check_oo_equals_jax_host_core(rng, route):
    """Keys, shared secrets with and without the KDF, signatures and
    verdicts (valid and tampered) of the port's classes on `route`, against
    the JAX package's classes on their host core."""
    jax_host_core()
    a_sk, b_sk, ed_sk = rng.bytes(32), rng.bytes(32), rng.bytes(32)
    a, ja = oo.X25519Private(a_sk, **route), joo.X25519Private(a_sk,
                                                              native=True)
    b_pk = joo.X25519Private(b_sk, native=True).get_public_key()
    assert a.get_public_key() == ja.get_public_key()
    for kdf in (False, True):
        assert a.create_shared_key(b_pk, kdf=kdf) == ja.create_shared_key(
            b_pk, kdf=kdf), (route, kdf)
    k, jk = oo.ED25519Private(ed_sk, **route), joo.ED25519Private(
        ed_sk, native=True)
    assert k.get_public_key() == jk.get_public_key()
    pub = oo.ED25519Public(k.get_public_key(), **route)
    jpub = joo.ED25519Public(jk.get_public_key(), native=True)
    for msg in (b"", rng.bytes(70)):
        sig = k.sign(msg)
        assert sig == jk.sign(msg)
        assert pub.verify(sig, msg)
        bad = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        assert not pub.verify(bad, msg) and not jpub.verify(bad, msg)
    if "device" in route:
        assert pub._ctx is not None               # built once and kept


def test_rfc7748_vectors():
    out = x25519.create_shared_key(hx(V1_U, V2_U), hx(V1_K, V2_K))
    assert hexes(out) == [V1_OUT, V2_OUT]
    pks = x25519.calculate_public_key(hx(A_SK, B_SK))
    assert hexes(pks) == [A_PK, B_PK]
    shared = x25519.create_shared_key(pks.flip(0), hx(A_SK, B_SK))
    assert hexes(shared) == [SHARED, SHARED]


def test_edge_u_and_zero_peer_match_oracle(rng):
    sk7 = torch.full((len(EDGE_U), 32), 7, dtype=torch.uint8)
    peers = torch.tensor([list(u.to_bytes(32, "little")) for u in EDGE_U],
                         dtype=torch.uint8)
    got = x25519.create_shared_key(peers, sk7)
    for row, u in zip(to_numpy(got), EDGE_U):
        assert bytes(row) == refmodel.x25519(b"\x07" * 32,
                                             u.to_bytes(32, "little"))
    zero = x25519.create_shared_key(torch.zeros(4, 32, dtype=torch.uint8),
                                    from_numpy(rand_bytes(rng, 4)))
    assert not zero.any()


def test_zr_does_not_change_the_output(rng):
    sk, peer = from_numpy(rand_bytes(rng, 4)), from_numpy(rand_bytes(rng, 4))
    zr = torch.from_numpy(np.stack(
        [int_to_limbs(int.from_bytes(rng.bytes(32), "little") % P or 1)
         for _ in range(4)]))
    assert torch.equal(x25519.create_shared_key(peer, sk, zr=zr),
                       x25519.create_shared_key(peer, sk))
    assert torch.equal(x25519.calculate_public_key(sk, zr=zr[0]),
                       x25519.calculate_public_key(sk))


def test_inputs_are_not_modified_and_bad_inputs_raise(rng):
    sk, peer = from_numpy(rand_bytes(rng, 2)), from_numpy(rand_bytes(rng, 2))
    peer[:, 31] |= 0x80                          # high bit set: masked inside
    sk0, peer0 = sk.clone(), peer.clone()
    x25519.create_shared_key(peer, sk)
    assert torch.equal(sk, sk0) and torch.equal(peer, peer0)
    with pytest.raises(ValueError):
        x25519.create_shared_key(peer.to(torch.int32), sk)
    with pytest.raises(ValueError):
        x25519.create_shared_key(peer, sk.to(torch.int32))
    with pytest.raises(ValueError):
        x25519.calculate_public_key(sk.to(torch.int32))
    with pytest.raises(ValueError):
        x25519.create_shared_key(peer[:, :31], sk)
    with pytest.raises(ValueError):
        x25519.create_shared_key(peer, sk, zr=torch.ones(2, 20))


def test_cpu_tensors_take_the_plain_version_without_launching(
        rng, monkeypatch, tmp_path):
    before = ladder_kernel.launches
    sk, peer = from_numpy(rand_bytes(rng, 2)), from_numpy(rand_bytes(rng, 2))
    got = ladder_kernel.point_multiply_cuda(peer, sk)
    assert ladder_kernel.launches == before
    assert torch.equal(got, montgomery.point_multiply(peer, sk))
    _check_trace_and_counters(tmp_path, monkeypatch)
    monkeypatch.undo()
    check_recorder(tmp_path, monkeypatch)


def _check_trace_and_counters(tmp_path, monkeypatch):
    """trace_summary finds a traced CPU op, most expensive first, with no
    device events on the CPU; Counter and timed print the JAX package's
    JSON for the same ops and seconds."""
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path)) as logdir:
        torch.mm(x, x)
    assert logdir == str(tmp_path)
    summary = profiling.trace_summary(logdir)
    assert summary["aten::mm"]["count"] == 1
    assert summary["aten::mm"]["total_us"] > 0
    totals = [v["total_us"] for v in summary.values()]
    assert totals == sorted(totals, reverse=True)
    assert list(profiling.trace_summary(logdir, prefix="aten::mm")) == [
        "aten::mm"]
    assert profiling.trace_device_events(logdir) == {}
    with pytest.raises(FileNotFoundError):
        profiling.trace_summary(logdir + "/empty")

    ticks = iter([10.0, 12.5, 10.0, 12.5])
    monkeypatch.setattr("time.perf_counter", lambda: next(ticks))
    port, ref = profiling.Counter("x25519"), jprofiling.Counter("x25519")
    with profiling.timed(port, 1000):
        pass
    with jprofiling.timed(ref, 1000):
        pass
    for base in (None, 300.0):
        assert port.json(base) == ref.json(base)
    assert json.loads(port.json(300.0)) == {
        "metric": "x25519", "value": 400.0, "unit": "ops/s",
        "vs_baseline": 1.333}
    assert profiling.Counter("idle").json() == jprofiling.Counter(
        "idle").json()


def test_numpy_inputs_follow_the_device_rule(rng):
    sk, peer = rand_bytes(rng, 3), rand_bytes(rng, 3)
    before = ladder_kernel.launches
    got = x25519.create_shared_key(peer, sk, device="cpu")
    assert got.device.type == "cpu" and ladder_kernel.launches == before
    assert torch.equal(got, montgomery.point_multiply(from_numpy(peer),
                                                      from_numpy(sk)))
    assert torch.equal(x25519.calculate_public_key(list(sk[0]), device="cpu"),
                       x25519.calculate_public_key(from_numpy(sk[0])))
    if not torch.cuda.is_available():
        # no device given and no card: raise, never a silent CPU run
        with pytest.raises(RuntimeError):
            x25519.create_shared_key(peer, sk)
        # and so do the OO classes, unless they are asked for the host core
        for cls in (oo.X25519Private, oo.ED25519Private, oo.ED25519Public):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                cls(b"\2" * 32)


def test_port_imports_no_jax():
    modules = ["curve25519_tpu_torch.%s" % m for m in (
        "refmodel", "_custom_blind", "ops.sha512", "ops.sc", "ops.fold",
        "models.tables", "models.edwards", "models.blinding",
        "models.ed25519", "models.x25519", "ops.cuda.sha512_kernel",
        "ops.cuda.edwards_kernel", "ops.cuda.sign_kernel",
        "ops.cuda.verify_kernel", "utils.interop", "utils.profiling",
        "native.bindings", "utils.rng", "utils.bucketing", "utils.checkpoint",
        "utils.debug", "oo", "tools.custom_tool", "parallel.mesh")]
    code = (
        "import importlib, sys\n"
        "import torch\n"
        "for m in %r:\n"
        "    importlib.import_module(m)\n"
        "from curve25519_tpu_torch.models import ed25519, x25519\n"
        "k = torch.tensor(list(bytes.fromhex('%s')), dtype=torch.uint8)\n"
        "u = torch.tensor(list(bytes.fromhex('%s')), dtype=torch.uint8)\n"
        "assert bytes(x25519.create_shared_key(u, k).tolist()).hex() == '%s'\n"
        "pk, priv = ed25519.create_keypair(k)\n"
        "assert bool(ed25519.verify(ed25519.sign(priv, u), pk, u))\n"
        "sig = ed25519.sign_ragged(priv, [b'', bytes(200)])\n"
        "assert ed25519.verify_ragged(sig, pk, [b'', bytes(200)]).all()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'curve25519_tpu']\n"
        "assert not bad, bad\n" % (modules, V1_K, V1_U, V1_OUT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
