"""The CUDA kernel's arithmetic, built for the CPU with g++.

ops/cuda/csrc/fe25519.cuh and the per-lane ladder of ladder.cu are
``__host__ __device__`` code; build.build_host compiles them with g++ into a
library whose host entries run the same per-lane code on the CPU. Here that
code is held, exactly, against:

- the port's plain field core (curve25519_tpu_torch.ops.fe), limb for limb;
- the TPU kernel's field core (curve25519_tpu.ops.pallas.fe_tile and
  sc_tile.limbs_from_byte_rows), run eagerly on [20, 1, B] tiles, limb for
  limb;
- the plain ladder (models/montgomery.point_multiply) and the Python oracle
  (curve25519_tpu.refmodel), byte for byte.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curve25519_tpu import refmodel
from curve25519_tpu.config import A24, P
from curve25519_tpu.ops import fe as jfe
from curve25519_tpu.ops.pallas import fe_tile as ft
from curve25519_tpu.ops.pallas import sc_tile as sct

from curve25519_tpu_torch.config import int_to_limbs
from curve25519_tpu_torch.models import montgomery
from curve25519_tpu_torch.ops import codec, fe
from curve25519_tpu_torch.ops.cuda import build

# the FeOp enum of ladder.cu
OPS = {"add": 0, "sub": 1, "neg": 2, "mul": 3, "sqr": 4, "mul_small_add": 5,
       "canon": 6, "inv": 7, "to_bytes": 8, "from_bytes": 9}

EDGE_U = [0, 1, P, P + 1, 2**255 - 1, 1 | 1 << 255]


@pytest.fixture(scope="module", autouse=True)
def _free_xla_executables():
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    return build.load_host(build.build_host(tmp_path_factory.mktemp("host")))


@pytest.fixture
def rng():
    return np.random.default_rng(25519)


def weak_limbs(rng, n):
    lo, hi = jfe.WEAK_MIN, jfe.WEAK_MAX
    rand = rng.integers(lo, hi + 1, (n, 20)).astype(np.int32)
    extreme = np.stack([np.full(20, lo), np.full(20, hi),
                        int_to_limbs(P - 1), int_to_limbs(0)])
    return np.concatenate([rand, extreme.astype(np.int32)])


def host_op(lib, name, x, y=None):
    x = np.ascontiguousarray(x, np.int32)
    y = None if y is None else np.ascontiguousarray(y, np.int32)
    out = np.zeros((len(x), 32 if name == "to_bytes" else 20), np.int32)
    rc = lib.fe25519_op_host(OPS[name], out.ctypes.data, x.ctypes.data,
                             None if y is None else y.ctypes.data, len(x))
    assert rc == 0
    return out


def host_ladder(lib, u, k, zr=None):
    """u, k: [n, 32] uint8 (k clamped); zr: [n, 20] int32 or None."""
    u, k = np.ascontiguousarray(u), np.ascontiguousarray(k)
    zr = None if zr is None else np.ascontiguousarray(zr, np.int32)
    out = np.zeros_like(u)
    lib.x25519_ladder_host(out.ctypes.data, u.ctypes.data, k.ctypes.data,
                           None if zr is None else zr.ctypes.data, len(u))
    return out


def tile(x):
    """[B, K] -> [K, 1, B], the fe_tile layout with one sublane."""
    return jnp.asarray(np.ascontiguousarray(x.T[:, None, :]))


def untile(t):
    return np.asarray(t)[:, 0, :].T


_TWIN = {
    "add": (lambda x, y: fe.add(x, y), lambda x, y: ft.t_add(x, y)),
    "sub": (lambda x, y: fe.sub(x, y), lambda x, y: ft.t_sub(x, y, ft.t_pad())),
    "neg": (lambda x, y: fe.neg(x), lambda x, y: ft.t_neg(x, ft.t_pad())),
    "mul": (lambda x, y: fe.mul(x, y), lambda x, y: ft.t_mul(x, y)),
    "sqr": (lambda x, y: fe.sqr(x), lambda x, y: ft.t_sqr(x)),
    "mul_small_add": (lambda x, y: fe.mul_small_add(x, A24, y),
                      lambda x, y: ft.t_mul_small_add(x, A24, y)),
    "canon": (lambda x, y: fe.canon(x), lambda x, y: ft.t_canon(x)),
    "to_bytes": (lambda x, y: fe.to_bytes(x).to(torch.int32),
                 lambda x, y: ft.t_to_bytes(x)),
}


@pytest.mark.parametrize("names", [("add", "sub"), ("neg", "mul_small_add"),
                                   ("mul", "sqr"), ("canon", "to_bytes")],
                         ids="-".join)
def test_field_ops_equal_twin_and_fe_tile(lib, rng, names):
    x, y = weak_limbs(rng, 48), weak_limbs(rng, 48)[::-1].copy()
    for name in names:
        got = host_op(lib, name, x, y)
        torch_fn, tile_fn = _TWIN[name]
        twin = torch_fn(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        np.testing.assert_array_equal(got, twin, err_msg=name)
        np.testing.assert_array_equal(got, untile(tile_fn(tile(x), tile(y))),
                                      err_msg=name)


def test_inv_equals_twin_and_fe_tile(lib, rng):
    x = weak_limbs(rng, 4)
    got = host_op(lib, "inv", x)
    np.testing.assert_array_equal(got, fe.inv(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(got, untile(ft.t_inv(tile(x))))


def test_from_bytes_equals_twin_and_sc_tile(lib, rng):
    b = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    b[-1] = 0xFF
    got = host_op(lib, "from_bytes", b.astype(np.int32))
    np.testing.assert_array_equal(got, fe.from_bytes(torch.from_numpy(b)).numpy())
    rows = tile(b.astype(np.int32))
    np.testing.assert_array_equal(got, untile(sct.limbs_from_byte_rows(rows)))


def test_host_ladder_equals_plain(lib, rng):
    u = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    k = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    u[0] = 0                                       # all-zero peer
    u[1, 31] |= 0x80                               # bit 255 set: masked
    k_cl = codec.clamp(torch.from_numpy(k)).numpy()
    got = host_ladder(lib, u, k_cl)
    want = montgomery.point_multiply(torch.from_numpy(u), torch.from_numpy(k))
    np.testing.assert_array_equal(got, want.numpy())
    assert not got[0].any()


def test_host_ladder_edge_u_and_zr_match_oracle(lib, rng):
    n = len(EDGE_U)
    u = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8)
                  for v in EDGE_U])
    k = codec.clamp(torch.full((n, 32), 7, dtype=torch.uint8)).numpy()
    zr = np.stack([int_to_limbs(int.from_bytes(rng.bytes(32), "little") % P
                                or 1) for _ in range(n)])
    got = host_ladder(lib, u, k)
    np.testing.assert_array_equal(host_ladder(lib, u, k, zr), got)
    for row, v in zip(got, EDGE_U):
        assert row.tobytes() == refmodel.x25519(b"\x07" * 32,
                                                v.to_bytes(32, "little"))
