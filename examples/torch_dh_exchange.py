"""Minimal end-to-end walkthrough of the PyTorch port: X25519 key exchange
and Ed25519 signing, single keys through the OO wrapper and batches through
the functional API (the port's counterpart of examples/dh_exchange.py).

Run from the repo root:  python examples/torch_dh_exchange.py [--device cpu]

On a CUDA card (the default) the batches run the hand-written kernels;
`--device cpu` runs their plain PyTorch versions, on a smaller batch.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(device):
    import torch
    from curve25519_tpu_torch.models import ed25519, x25519
    from curve25519_tpu_torch.oo import (
        ED25519Private, ED25519Public, X25519Private,
    )

    # --- single keys, host bytes (reference C++-wrapper style) ------------
    alice, bruce = X25519Private(device=device), X25519Private(device=device)
    k_ab = alice.create_shared_key(bruce.get_public_key())
    k_ba = bruce.create_shared_key(alice.get_public_key())
    assert k_ab == k_ba
    print(f"DH shared secret (KDF'd): {k_ab.hex()}")

    signer = ED25519Private(device=device)
    sig = signer.sign(b"attack at dawn")
    ok = ED25519Public(signer.get_public_key(), device=device).verify(
        sig, b"attack at dawn")
    print(f"signature valid: {ok}")

    # --- batched: one call = thousands of ops -----------------------------
    rng = np.random.default_rng(0)
    B = 4096 if torch.device(device).type == "cuda" else 16

    def batch(width):
        return torch.as_tensor(rng.integers(0, 256, (B, width),
                                            dtype=np.uint8), device=device)

    sk_a, sk_b = batch(32), batch(32)
    pk_a = x25519.calculate_public_key_fast(sk_a)
    pk_b = x25519.calculate_public_key_fast(sk_b)
    assert torch.equal(x25519.create_shared_key(pk_b, sk_a),
                       x25519.create_shared_key(pk_a, sk_b))
    print(f"{B} batched DH exchanges agree")

    seed, msg = batch(32), batch(64)
    pk, priv = ed25519.create_keypair(seed)
    sigs = ed25519.sign(priv, msg)
    ctx = ed25519.verify_init(pk)           # cacheable per-pubkey phase
    ok = ed25519.verify_check(ctx, sigs, msg)
    print(f"{int(ok.sum())}/{B} batched signatures verified")
    assert bool(ok.all())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (plain versions)")
    main(ap.parse_args().device)
