"""Variable-length inputs without dynamic shapes, on the PyTorch port: the
streaming SHA-512, ragged sign/verify batches bucketed by block count, and a
saved (checkpointed) two-phase verify context (the port's counterpart of
examples/streaming_and_ragged.py).

Run from the repo root:
    python examples/torch_streaming_and_ragged.py [--device cpu]

On a CUDA card (the default) the batches run the hand-written kernels;
`--device cpu` runs their plain PyTorch versions, on fewer messages. The
streaming SHA-512 runs on the port's C++ host core either way (built with
g++ at first use).
"""

import argparse
import hashlib
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(device):
    import torch
    from curve25519_tpu_torch.models import ed25519
    from curve25519_tpu_torch.ops.sha512 import Sha512
    from curve25519_tpu_torch.utils import checkpoint

    # --- streaming SHA-512: O(1) memory, any length -----------------------
    # Only (8-word state, <128-byte tail, exact length) is kept between
    # calls, like the reference's SHA512_Init/Update/Final, so a stream
    # never needs to exist in memory at once.
    h = Sha512()
    ref = hashlib.sha512()
    rng = np.random.default_rng(0)
    for _ in range(64):
        chunk = rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
        h.update(chunk)
        ref.update(chunk)
    digest = h.final()
    assert digest == ref.digest()
    print(f"streamed 4 MiB in 64 KiB chunks: sha512 = {digest[:8].hex()}… "
          "(matches hashlib)")

    # --- ragged Ed25519 batch: one call per distinct block count ----------
    # Messages of mixed lengths are grouped into same-block-count buckets;
    # no lane pays another lane's padding, and results come back in input
    # order.
    cuda = torch.device(device).type == "cuda"
    n, max_len = (512, 4096) if cuda else (8, 400)
    msgs = [rng.integers(0, 256, int(L), dtype=np.uint8).tobytes()
            for L in rng.integers(0, max_len, n)]
    seed = rng.integers(0, 256, (32,), dtype=np.uint8)
    pk, priv = ed25519.create_keypair(seed, device=device)

    sigs = ed25519.sign_ragged(priv, msgs)
    ok = ed25519.verify_ragged(sigs, pk, msgs)
    print(f"ragged batch: {int(ok.sum())}/{n} mixed-length signatures "
          f"verified (lengths 0..{max_len - 1})")
    assert bool(ok.all())

    # --- two-phase verify with a checkpointed context ---------------------
    # verify_init's q_table is a cacheable precompute (the reference's
    # EDP_SIGV_CTX); save it once per pubkey and reuse it across batches
    # and processes: verify_ragged then runs no Verify_Init.
    ctx = ed25519.verify_init(pk)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "verify_ctx.npz")
        checkpoint.save_verify_ctx(path, ctx)
        ctx2 = checkpoint.load_verify_ctx(path, device=device)
    ok2 = ed25519.verify_ragged(sigs, pk, msgs, ctx=ctx2)
    assert bool(ok2.all())
    print("reloaded verify ctx from disk; ragged verify ran with no "
          "Verify_Init")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (plain versions)")
    main(ap.parse_args().device)
