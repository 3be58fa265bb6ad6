"""The plain reference against the RFCs' own vectors, and the benchmark's
seeded signer against the reference's verification (CPU only)."""

import numpy as np
import pytest

from portbench import harness
from portbench.reference import curve

H = bytes.fromhex

# RFC 7748 section 5.2: (scalar, u, output)
X25519_VECTORS = [
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
]

# RFC 7748 section 6.1
ALICE_SK = "77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a"
ALICE_PK = "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"
BOB_SK = "5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb"
BOB_PK = "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"
SHARED = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"

# RFC 8032 section 7.1 TEST 1-3: (secret, public, message, signature)
ED25519_VECTORS = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


@pytest.mark.parametrize("k, u, out", X25519_VECTORS)
def test_x25519_rfc7748_5_2(k, u, out):
    assert curve.x25519(H(k), H(u)) == H(out)


def test_x25519_rfc7748_6_1():
    nine = (9).to_bytes(32, "little")
    for sk, pk in ((ALICE_SK, ALICE_PK), (BOB_SK, BOB_PK)):
        assert curve.x25519_base(H(sk)) == H(pk)
        assert curve.x25519(H(sk), nine) == H(pk)
    assert curve.x25519(H(ALICE_SK), H(BOB_PK)) == H(SHARED)
    assert curve.x25519(H(BOB_SK), H(ALICE_PK)) == H(SHARED)


@pytest.mark.parametrize("sk, pk, msg, sig", ED25519_VECTORS)
def test_ed25519_rfc8032_7_1(sk, pk, msg, sig):
    assert curve.public_key(H(sk)) == H(pk)
    assert curve.sign(H(sk), H(msg)) == H(sig)
    assert curve.verify(H(sig), H(pk), H(msg))
    bad = bytearray(H(sig))
    bad[0] ^= 1
    assert not curve.verify(bytes(bad), H(pk), H(msg))
    assert not curve.verify(H(sig), H(pk), H(msg) + b"\0")


def test_verify_decode_rules():
    """S >= l is used as it is unless strict; an off-curve key fails."""
    sk, pk, msg, sig = (H(x) for x in ED25519_VECTORS[0])
    s = int.from_bytes(sig[32:], "little") + curve.L
    high = sig[:32] + s.to_bytes(32, "little")
    assert curve.verify(high, pk, msg)
    assert not curve.verify(high, pk, msg, strict=True)
    off = next(y for y in range(2, 100) if curve.decode(
        y.to_bytes(32, "little")) is None)
    assert not curve.verify(sig, off.to_bytes(32, "little"), msg)


def test_signer_and_corruptions():
    """Every packet the seeded signer makes verifies under the reference,
    and each corrupted lane fails, R, S and message flips alike."""
    files = harness.Files("sigverify.padded")
    n, pool = 48, 2
    made = files.deployment.make(files.config, {"batch": n, "pool": pool},
                                 2**31 + 11)
    lanes = made["lanes"]
    bad = set(made["strata"]["invalid"].tolist())
    per_batch = n // files.config["invalid_one_in"]
    assert len(bad) == pool * per_batch
    assert all(sum(p * n <= i < (p + 1) * n for i in bad) == per_batch
               for p in range(pool))
    assert lanes["msg_len"].min() >= files.config["min_message_bytes"]
    assert lanes["msg_len"].max() <= files.config["max_message_bytes"]
    for i in range(n * pool):
        ok = curve.verify(lanes["sig"][i].tobytes(), lanes["pk"][i].tobytes(),
                          lanes["msg"][i, :lanes["msg_len"][i]].tobytes())
        assert ok == (i not in bad), i
    # the same set of lengths for every seed, in another order
    other = files.deployment.make(files.config, {"batch": n, "pool": pool},
                                  5)
    assert sorted(other["lanes"]["msg_len"]) == sorted(lanes["msg_len"])
    assert not np.array_equal(other["lanes"]["msg_len"], lanes["msg_len"])


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench.reference import curve, tls13_x25519_ed25519, "
            "solana_sigverify; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('curve25519_tpu_torch', 'curve25519_tpu', 'jax', 'torch')))"
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
