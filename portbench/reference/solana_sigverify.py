"""The plain reference of a Solana packet batch's signature verification
(RFC 8032 on Python integers, reference/curve.py), and the benchmark's own
seeded signer of the packets.

The signer gives signature i the nonce r0 + i, so that R_{i+1} = R_i + B:
one point addition a signature and one inversion for all, in place of a
scalar multiply each. Verification does not depend on how r was chosen.
"""

import numpy as np

from portbench.reference import curve


def keys(seeds):
    """[(a, public key bytes)] of 32-byte secret seeds."""
    out = []
    for seed in seeds:
        a, _ = curve.secret_scalar(seed)
        out.append((a, curve.encode(curve.base_mult(a))))
    return out


def sign_packets(key_pool, signer, msg, msg_len, r0):
    """[B, 64] uint8 signatures of msg[i, :msg_len[i]] by key_pool[signer[i]]
    with nonce r0 + i."""
    n = len(signer)
    base = curve.niels(curve.BASE)
    points, p = [], curve.base_mult(r0)
    for _ in range(n):
        points.append(p)
        p = curve.add_niels(p, base)
    big_r = curve.encode_many(points)
    sig = np.empty((n, 64), np.uint8)
    for i in range(n):
        a, pk = key_pool[signer[i]]
        m = msg[i, :msg_len[i]].tobytes()
        s = (r0 + i + curve.challenge(big_r[i], pk, m) * a) % curve.L
        sig[i] = np.frombuffer(big_r[i] + s.to_bytes(32, "little"), np.uint8)
    return sig


def judge(config, made, lanes, outputs):
    """{"verdict_mismatch": (lanes whose verdict differs from RFC 8032
    verification, 0)} over the sampled canonical `lanes`."""
    inputs = made["lanes"]
    bad = 0
    for row, lane in enumerate(lanes):
        want = curve.verify(inputs["sig"][lane].tobytes(),
                            inputs["pk"][lane].tobytes(),
                            inputs["msg"][lane, :inputs["msg_len"][lane]]
                            .tobytes(), strict=config["strict"])
        bad += bool(outputs["verdict"][row]) != want
    return {"verdict_mismatch": (bad, 0)}
