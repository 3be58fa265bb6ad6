"""The CUDA ladder kernel on the card, against its plain PyTorch version.

Every test here needs a CUDA card and nvcc, is marked `cuda`, and skips
where torch.cuda.is_available() is false. The file imports no jax, so it also
runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance: exact bytes.
"""

import numpy as np
import pytest
import torch

from curve25519_tpu import refmodel
from curve25519_tpu.config import P

from curve25519_tpu_torch.config import int_to_limbs
from curve25519_tpu_torch.models import montgomery, x25519
from curve25519_tpu_torch.ops.cuda import ladder_kernel

pytestmark = pytest.mark.cuda

# RFC 7748 5.2 vector 1 and the x25519_edge_u values of
# benchmarks/tpu_vectors.py
V1_K = "a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4"
V1_U = "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c"
V1_OUT = "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"
EDGE_U = [0, 1, P, P + 1, 2**255 - 1, 1 | 1 << 255]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def rng():
    return np.random.default_rng(90)


def on(dev, arr):
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def test_kernel_equals_plain(dev, rng):
    n = 1024 + 37                                  # not a multiple of a block
    sk = on(dev, rng.integers(0, 256, (n, 32), dtype=np.uint8))
    peer = on(dev, rng.integers(0, 256, (n, 32), dtype=np.uint8))
    zr = on(dev, np.stack([int_to_limbs(int.from_bytes(rng.bytes(32), "little")
                                        % P or 1) for _ in range(n)]))
    before = ladder_kernel.launches
    got = x25519.create_shared_key(peer, sk)
    torch.cuda.synchronize()
    assert ladder_kernel.launches == before + 1
    assert torch.equal(got, montgomery.point_multiply(peer, sk))
    assert torch.equal(x25519.create_shared_key(peer, sk, zr=zr), got)
    assert torch.equal(x25519.create_shared_key(peer[7], sk[7]), got[7])
    assert torch.equal(x25519.create_shared_key(peer[0], sk[:9]),
                       montgomery.point_multiply(peer[0], sk[:9]))


def test_kernel_known_answers(dev):
    k = on(dev, np.frombuffer(bytes.fromhex(V1_K), np.uint8))
    u = on(dev, np.frombuffer(bytes.fromhex(V1_U), np.uint8))
    assert bytes(x25519.create_shared_key(u, k).cpu().tolist()).hex() == V1_OUT
    peers = on(dev, np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8)
                              for v in EDGE_U]))
    sk7 = torch.full((len(EDGE_U), 32), 7, dtype=torch.uint8, device=dev)
    got = x25519.create_shared_key(peers, sk7).cpu().numpy()
    for row, v in zip(got, EDGE_U):
        assert row.tobytes() == refmodel.x25519(b"\x07" * 32,
                                                v.to_bytes(32, "little"))


def test_kernel_rejects_mixed_devices(dev):
    sk = torch.zeros(2, 32, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        x25519.create_shared_key(torch.zeros(2, 32, dtype=torch.uint8), sk)
